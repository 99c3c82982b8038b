"""Build the CUDA sources in `voxel_tracer_tpu_torch/csrc/` at first use.

Each `csrc/<name>.cu` compiles with `nvcc` into a shared library with a
plain C interface, `build/voxel_tracer_tpu_torch/lib<name>-<hash>.so` at
the root of the checkout, loaded with ctypes.  The hash covers every
source in `csrc/` and the compiler flags, so a second run reuses the
library and an edited source rebuilds it.  Nothing here runs at import
time: a machine without `nvcc` can import the package and use the plain
PyTorch versions on CPU tensors.

Flags: `sm_90a` (Hopper), `-O3`, and `--fmad=false` so the compiler
contracts no multiply-add on its own; the kernels call `fmaf` where the
plain versions fuse one.  No `--use_fast_math`: it would flush denormals
and approximate division, sqrt and exp.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "voxel_tracer_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "voxel_tracer_tpu_torch build only where the CUDA "
                           "toolkit is installed")
    return path


def lib_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` lives for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: every `csrc/*.cu`), one `nvcc`
    process each, all started together.  Sources whose library exists are
    skipped.  Returns {name: compiler output} (ptxas register and spill
    report) and raises if any compile fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            path = lib_path(name)
            if not path.exists():
                build([name])
            _LIBS[name] = ctypes.CDLL(str(path))
        return _LIBS[name]
