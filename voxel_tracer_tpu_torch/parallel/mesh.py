"""Device meshes over `torch.distributed` process groups.

Counterpart of `voxel_tracer_tpu/parallel/mesh.py` and of the mesh half of
`grid_shard.py`.  Axis convention (SURVEY.md §2.4):

- ``"rays"``: the data-parallel axis; rays and pixels are sharded over it
  as contiguous blocks, what `PartitionSpec("rays")` places on a device;
- ``"grid"``: the model-parallel axis of the brick-sharded mode; the
  voxel grid is split into brick-aligned z-slabs over it.

One process drives one device, so a mesh of D devices is D ranks.  Ranks
are laid out row-major over the axes in the order given: in a
(``"rays"``, ``"grid"``) mesh of (r, g), rank = i_ray * g + j_grid, as
JAX's `devices.reshape(n_ray, n_grid)`.  Each axis is a process subgroup
(the ranks that share every other coordinate); every rank creates every
subgroup, in the same order, as `torch.distributed.new_group` requires.
An axis of size 1, or any axis when no process group is initialized,
needs no collective: its reductions are the identity.

The collectives are `all_reduce` and `all_gather` on the tensors as they
are: NCCL takes CUDA tensors, and gloo takes them too in both (the
worker's ``probe`` mode checks it on the card), so nothing is staged
through the host here.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch
import torch.distributed as dist

RAYS = "rays"
GRID = "grid"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A rank's view of a device mesh: axis sizes, its coordinate on each
    axis, and the process subgroup of each axis (None: no collective)."""

    axis_names: tuple
    shape: dict
    coords: dict
    groups: dict
    device: torch.device

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n

    # -- collectives over one axis ------------------------------------------

    def psum(self, axis: str, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the ranks of ``axis`` (a new tensor)."""
        group = self.groups[axis]
        out = t.detach().clone().contiguous()
        if group is not None:
            dist.all_reduce(out, group=group)
        return out

    def pmean(self, axis: str, t: torch.Tensor) -> torch.Tensor:
        """Mean of ``t`` over the ranks of ``axis``: the sum, then one
        division by the axis size (JAX's `pmean`)."""
        return self.psum(axis, t) / self.shape[axis]

    def all_gather(self, axis: str, t: torch.Tensor) -> torch.Tensor:
        """(n, *t.shape): every rank's ``t`` along ``axis``, in axis
        order."""
        group = self.groups[axis]
        t = t.detach().contiguous()
        if group is None:
            return t[None].clone()
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t, group=group)
        return torch.stack(parts)

    # -- placement ----------------------------------------------------------

    def block(self, axis: str, n: int) -> slice:
        """This rank's contiguous block of ``n`` rows split over ``axis``."""
        k = self.shape[axis]
        assert n % k == 0, f"{n} rows do not split over {k} {axis!r} ranks"
        b = n // k
        j = self.coords[axis]
        return slice(j * b, (j + 1) * b)


def make_mesh(axes, device="cuda") -> Mesh:
    """Mesh over ``axes``, a sequence of (name, size) in rank-major order.

    Under an initialized process group the sizes must multiply to the
    world size; without one, the mesh is the single rank 0 and every
    axis has size 1."""
    names = tuple(a for a, _ in axes)
    sizes = tuple(int(s) for _, s in axes)
    device = torch.device(device)
    if not dist.is_initialized():
        assert all(s == 1 for s in sizes), (
            f"a mesh of {sizes} needs an initialized process group")
        return Mesh(names, dict(zip(names, sizes)), {a: 0 for a in names},
                    {a: None for a in names}, device)
    world, rank = dist.get_world_size(), dist.get_rank()
    total = 1
    for s in sizes:
        total *= s
    assert total == world, f"mesh {dict(zip(names, sizes))} needs {total} ranks, have {world}"
    strides, st = {}, 1
    for a, s in reversed(list(zip(names, sizes))):
        strides[a] = st
        st *= s
    coords = {a: rank // strides[a] % s for a, s in zip(names, sizes)}
    groups = {}
    for ax, size in zip(names, sizes):
        if size == world:
            groups[ax] = dist.group.WORLD
            continue
        groups[ax] = None
        if size == 1:
            continue
        others = [(a, s) for a, s in zip(names, sizes) if a != ax]
        for combo in itertools.product(*(range(s) for _, s in others)):
            base = sum(c * strides[a] for c, (a, _) in zip(combo, others))
            ranks = [base + k * strides[ax] for k in range(size)]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[ax] = g
    return Mesh(names, dict(zip(names, sizes)), coords, groups, device)


def world_size() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _world_for(n_devices, devices) -> int:
    """The world size, checked against a JAX-style device count or device
    list.  One process drives one device, so a mesh spans every rank of
    the process group: ``n_devices`` must be the world size and
    ``devices``, ranks, must be ``range(world)``."""
    world = world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs a process group of "
                         f"{n_devices} ranks, not {world}: one process drives one device")
    if devices is not None and list(devices) != list(range(world)):
        raise ValueError(f"a mesh over ranks {list(devices)} must span the process "
                         f"group's {world} ranks, range({world})")
    return world


def make_ray_mesh(n_devices=None, devices=None, *, device="cuda") -> Mesh:
    """1-D mesh over every rank of the process group (or the one process),
    as JAX's `make_ray_mesh(n_devices, devices)`; a count or rank list
    that is not the whole world raises ValueError."""
    return make_mesh(((RAYS, _world_for(n_devices, devices)),), device)


def make_ray_grid_mesh(n_ray: int, n_grid: int, devices=None, *, device="cuda") -> Mesh:
    """2-D mesh: (rays, grid), as JAX's `grid_shard.make_ray_grid_mesh`;
    n_ray * n_grid must be the world size."""
    _world_for(n_ray * n_grid, devices)
    return make_mesh(((RAYS, n_ray), (GRID, n_grid)), device)


def pad_to_multiple(n: int, devices: int) -> int:
    """Rays must divide evenly across the mesh; pad count to a multiple."""
    return ((n + devices - 1) // devices) * devices


def shard_rays(mesh: Mesh, x):
    """This rank's contiguous block of the rows of ``x`` over RAYS."""
    return x[mesh.block(RAYS, x.shape[0])]
