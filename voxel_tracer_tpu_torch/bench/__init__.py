"""The port's benchmark suite: `bench.py`'s headline and `bench_suite.py`'s
workloads on the port's entry points, plus PERF.md §2's end-to-end
metrics, on one CUDA device.

    python -m voxel_tracer_tpu_torch.bench [--one NAME] [--seed S] [--out PATH]

`workloads` builds each workload and holds its frames against their
plain versions; `measure` times them on the card, splits their device
time by kernel and counts host syncs; `__main__` is the command line.
"""
