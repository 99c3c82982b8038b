#!/usr/bin/env python3
"""How the host moves a host-bound frame's time, and how often
`chip_smoke.py`'s two-count agreement check would fail under that noise.

Renders `chip_smoke.py`'s [multi] frame (the default scene, 1280x768,
game_demo's config) ``--frames`` times, one at a time on the card, and
records each frame's host-clock ms (synchronized) and the ms Python's
garbage collector spent inside it.  Then it resamples the recorded times
in blocks of ``--block`` consecutive frames (the noise drifts over a few
seconds) and reports, for several (frame counts, rounds, statistic)
designs of `voxel_tracer_tpu_torch/bench/measure.alternating_rounds`, the
share of simulated attempts whose two per-frame times differ by more than
`chip_smoke.SLOPE_RTOL`.

Prints the frame times, the GC time, and a JSON summary as the last line.

Run from the repository root on a machine with a card:
    python3 tools/torch_frame_noise.py [--frames 60] [--block 6]
"""

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch

DESIGNS = [((3, 9), 1, "mean"), ((3, 9), 3, "mean"), ((3, 9), 5, "median"),
           ((1, 3), 15, "median"), ((1, 3), 15, "mean"), ((2, 6), 8, "mean")]


def frame_times(frames):
    """(ms, gc ms) of each of ``frames`` serialized [multi] frames."""
    import chip_smoke as cs
    from voxel_tracer_tpu_torch.ops.cuda import mega
    from voxel_tracer_tpu_torch.ops.cuda.multi import render_whitted_multi
    vols, scene = cs.multi_scene()
    sd = scene.data("cuda")
    multi = cs.build_multi([mega.MegaVolume(v, "cuda") for v in vols])
    cfg, cam = cs.multi_config(cs.MU_W, cs.MU_H), cs.multi_camera(0.0, cs.MU_W, cs.MU_H)

    def frame():
        render_whitted_multi(multi, sd, cam, cs.MU_W, cs.MU_H, 0, config=cfg)
        torch.cuda.synchronize()

    frame()
    in_gc, start = [0.0], [0.0]

    def on_gc(phase, _info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            in_gc[0] += time.perf_counter() - start[0]

    gc.callbacks.append(on_gc)
    ms, gc_ms = [], []
    for _ in range(frames):
        in_gc[0] = 0.0
        t0 = time.perf_counter()
        frame()
        ms.append((time.perf_counter() - t0) * 1e3)
        gc_ms.append(in_gc[0] * 1e3)
    gc.callbacks.remove(on_gc)
    return np.array(ms), np.array(gc_ms)


def failure_share(times, counts, rounds, stat, block, rtol, trials, rng):
    """Share of simulated attempts of the two-count check that disagree."""
    n = sum(counts) * rounds
    fails = 0
    for _ in range(trials):
        seq = []
        while len(seq) < n:
            i = rng.integers(0, len(times) - block + 1)
            seq.extend(times[i:i + block])
        k, per = 0, ([], [])
        for r in range(rounds):
            for j in ((0, 1) if r % 2 == 0 else (1, 0)):
                per[j].append(np.mean(seq[k:k + counts[j]]))
                k += counts[j]
        a, b = ((np.median(p) if stat == "median" else np.mean(p)) for p in per)
        fails += abs(b - a) > rtol * b
    return fails / trials


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--block", type=int, default=6)
    ap.add_argument("--trials", type=int, default=4000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_frame_noise: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    ms, gc_ms = frame_times(args.frames)
    print(f"frame ms: {[round(float(v), 1) for v in ms]}")
    print(f"mean {ms.mean():.1f}, sd {ms.std():.1f} ({ms.std() / ms.mean():.3f} of the mean), "
          f"min {ms.min():.1f}, max {ms.max():.1f}; time in gc {gc_ms.sum():.1f} ms in all")
    rng = np.random.default_rng(0)
    designs = []
    for counts, rounds, stat in DESIGNS:
        share = failure_share(ms, counts, rounds, stat, args.block, cs.SLOPE_RTOL,
                              args.trials, rng)
        designs.append(dict(counts=counts, rounds=rounds, stat=stat,
                            frames=sum(counts) * rounds, fail_share=share))
        print(f"counts {counts} x {rounds} rounds, {stat}: {share:.4f} of attempts disagree "
              f"(three attempts all failing: {share ** 3:.2e})")
    print(json.dumps(dict(device=smi, frame_ms=ms.tolist(), gc_ms=float(gc_ms.sum()),
                          designs=designs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
