"""The reference scene of rigid volumes: each volume with the rotation
given, for scenes whose objects move and turn (the game scene's drones).

`build` makes `render.RefScene.build`'s scene, whose volumes all have the
identity rotation, and gives each object the rotation handed with it:
volumes of one grid shape stacked into a `render.Group`, groups in the
order of their shapes, objects in the order given (`order`), which is the
order in which a hit's ``obj`` counts them.  Everything downstream
(traversal, candidate slots, shading) is `render.py`'s, which reads each
object's rotation from ``Group.rot``.  Plain float32 PyTorch; it imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.render import RefScene, identity


def order(volumes):
    """The global object index of each of ``volumes`` (tuples whose first
    item is the grid) in the scene `build` makes of them: groups by grid
    shape, objects in the order given."""
    ranked = sorted(range(len(volumes)), key=lambda i: np.shape(volumes[i][0]))
    return [ranked.index(i) for i in range(len(volumes))]


def build(volumes, lights, sky, sun_dir, sun_light, device, q=identity):
    """``volumes``: [(grid uint8 (Z, Y, X), palette (256, 3), pos (3,), rot
    (3, 3), vpu)], each volume's pivot at its centre; ``lights``: [(origin,
    radius, color, power)].  TF32 is turned off for matrix products and
    cuDNN (the reference computes in float32 throughout)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = RefScene.build([(g, pal, pos, vpu) for g, pal, pos, _rot, vpu in volumes],
                           lights, sky, sun_dir, sun_light, device, q=q)
    rots = [None] * len(volumes)
    for v, o in zip(volumes, order(volumes)):
        rots[o] = np.asarray(v[3], np.float32).reshape(3, 3)
    groups, base = [], 0
    for g in scene.groups:
        n = g.grid.shape[0]
        groups.append(g._replace(rot=torch.tensor(np.stack(rots[base:base + n]), device=device)))
        base += n
    return scene._replace(groups=tuple(groups))
