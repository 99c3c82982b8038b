"""The benchmark of the PyTorch / CUDA port (`voxel_tracer_tpu_torch`) on one
NVIDIA H100.

One command runs one cell of `BENCHMARK.json` once, from the root of a
checkout:

    python3 -m port_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It builds the cell's inputs from the seed, sets the program up and warms
up the cell's shapes (`setup_s`), measures a closed loop of frames or
optimizer steps for ``--seconds`` (`frame_ms`, `frame_ms_p95`, `step_ms`),
with ``--trace 1`` reads the per-layer metrics over a fixed set of frames
or steps (a profiler window, a window with host ops, PyTorch's sync
debug mode), and then holds what the window produced against the plain
reference in `reference/` (`correct`).  It prints each number compared
beside its limit as the last lines of standard error and one JSON line as
the last line of standard output.  Without a CUDA device it exits with code 2 and prints no result.

Where things are, each found by name from `BENCHMARK.json`:

- `configs/<config>.json`: a configuration (scene or field, sizes, entry
  point, `source`, `reduced`, `assumed`); `scenes/<scene>.py` builds its
  raw arrays from the seed.
- `mixes/<traffic>.json`: a traffic mix (orbit, shading, batch, the
  driver it runs, how many units the traced readings take).
- `drivers/<driver>.py`: one per entry point the window drives
  (`Renderer.render`, `Trainer.fit`).
- `limits/<cell>.json`: the limit of each number a cell's check compares
  (`compare.py` defines the numbers).
- `metrics/<metric>.py`: the reader of one per-layer metric;
  `profile.py` (device windows, kernel labels, host syncs) and
  `roofline.py` (peaks, the work counted from the reference) serve them.
- `reference/`: the plain reference, plain PyTorch that imports nothing
  of the program.
- `control.py`: the readings the limits were set from (the bfloat16
  control, a fit's planted fault, the program over many seeds); the
  benchmark's own runs never run it.
- `tests/`: CPU tests at tiny sizes (`python -m pytest port_bench/tests`);
  tests marked `cuda` skip without a card.

Caches and files: the port builds its CUDA libraries on first use into
`build/voxel_tracer_tpu_torch/` at the root of the checkout (keyed on a
hash of its sources), so only a checkout's first run of a cell compiles.
A run writes nothing else: no file
in `/dev/shm` or at a fixed `/tmp` path; whatever a library writes goes
under the `HOME`, `XDG_CACHE_HOME` and `TMPDIR` it is given.
"""
