"""Process-group bootstrap: a `torch.distributed.init_process_group`
wrapper.

Counterpart of `voxel_tracer_tpu/parallel/distributed.py` (the
`jax.distributed` wrapper).  One process drives one device; on a single
process this is a no-op.  The backend follows the device, ``"nccl"`` for
a CUDA device and ``"gloo"`` for the CPU, unless the caller names one; it
never switches backend or device on its own, so NCCL asked for without a
GPU raises.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               init_method: str | None = None, device="cuda",
               timeout_s: float = 300.0) -> bool:
    """Initialize the default process group if the caller or the
    environment asks for one; returns whether a group was initialized.

    Priority: explicit arguments (``coordinator`` "host:port" or an
    ``init_method`` URL, with ``num_processes`` and ``process_id``) >
    the launcher's environment (MASTER_ADDR / MASTER_PORT / WORLD_SIZE /
    RANK, as `torchrun` sets it) > a single-process no-op.
    """
    if coordinator is not None and init_method is None:
        init_method = f"tcp://{coordinator}"
    if init_method is None and num_processes is None:
        if not all(k in os.environ for k in _ENV):
            return False                     # single process
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    if init_method is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs an init method (coordinator "
                         "or init_method), num_processes and process_id")
    backend = backend or default_backend(device)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA device; "
                               "pass device='cpu' for gloo")
        index = torch.device(device).index
        torch.cuda.set_device(process_id % torch.cuda.device_count()
                              if index is None else index)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown():
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info():
    """The four keys of the JAX `process_info`; every rank is one device."""
    init = dist.is_initialized()
    world = dist.get_world_size() if init else 1
    return dict(
        process_index=dist.get_rank() if init else 0,
        process_count=world,
        local_devices=1,
        global_devices=world,
    )
