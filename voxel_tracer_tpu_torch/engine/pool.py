"""Fixed-capacity object pool (src/engine/datastruct/pool.h:14-134 analog).

Counterpart of `voxel_tracer_tpu/engine/pool.py`.
"""

from __future__ import annotations

from typing import Generic, Iterator, Optional, TypeVar

T = TypeVar("T")


class Pool(Generic[T]):
    """Slot pool with active flags and stable handles."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._items: list[Optional[T]] = [None] * capacity
        self._active = [False] * capacity
        self._count = 0

    def add(self, item: T) -> int:
        """Insert; returns slot handle. Raises when full."""
        for i in range(self.capacity):
            if not self._active[i]:
                self._items[i] = item
                self._active[i] = True
                self._count += 1
                return i
        raise RuntimeError("Pool is full")

    def remove(self, handle: int):
        if self._active[handle]:
            self._active[handle] = False
            self._items[handle] = None
            self._count -= 1

    def get(self, handle: int) -> Optional[T]:
        return self._items[handle] if self._active[handle] else None

    def __len__(self) -> int:
        return self._count

    def __iter__(self) -> Iterator[T]:
        for i in range(self.capacity):
            if self._active[i]:
                yield self._items[i]

    def handles(self) -> Iterator[int]:
        for i in range(self.capacity):
            if self._active[i]:
                yield i
