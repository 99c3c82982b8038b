"""Structured metrics logging (JSONL) for training loops.

Counterpart of `voxel_tracer_tpu/utils/logging.py`, copied: one JSON
object per step, appended to a file and optionally echoed to stdout.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Optional


class MetricsLogger:
    """Append-only JSONL metrics stream with a monotonic step counter.

    >>> log = MetricsLogger("/tmp/run/metrics.jsonl", echo=True)
    >>> log.log(loss=0.12, rays_per_s=7.3e8)
    >>> log.log(step=100, loss=0.05)          # explicit step override
    """

    def __init__(self, path: Optional[str] = None, echo: bool = False,
                 stream: Optional[IO] = None):
        self.path = path
        self.echo = echo
        self._stream = stream
        self._step = 0
        self._t0 = time.monotonic()
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._file = open(path, "a", buffering=1)
        else:
            self._file = None

    def log(self, step: Optional[int] = None, **metrics):
        if step is None:
            step = self._step
        self._step = step + 1
        rec = {"step": step,
               "t": round(time.monotonic() - self._t0, 4)}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        line = json.dumps(rec)
        if self._file:
            self._file.write(line + "\n")
        if self.echo:
            print(line, file=self._stream or sys.stdout, flush=True)
        return rec

    def close(self):
        if self._file:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
