"""The port's public surface against the JAX package's, read with `ast`.

Every public top-level function, class, public method and UPPER constant
of each `voxel_tracer_tpu/**.py` must have a counterpart of the same name
in the port's file of the same path (`ops/pallas/` -> `ops/cuda/`), and
each counterpart function's positional parameters must begin with the
JAX function's, in the same order, and it must take each of the JAX
function's keyword-only parameters: a JAX caller's call carries over
unchanged.  Trailing extras (a `device`, say) are allowed.  The
exceptions are `NOT_OWED`, one line each with its reason.

Nothing is imported from either package, so this runs without JAX.
"""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "voxel_tracer_tpu"
PORT_PKG = ROOT / "voxel_tracer_tpu_torch"

_PACK = "TPU table packer or its set-voxel variant; the port has one table set, MegaTables"
_TILE = "the port launches one thread per ray: no TPU tile or lane constant"
_ARGS = "TPU tile, traversal and layout arguments; the port walks one ray per thread"
_LAYOUT = "TPU VMEM layout of the tables; the port has one layout"

# "path:name" (a method as "path:Class.name") -> why the port does not
# carry the name, or its parameters, over
NOT_OWED = {
    "ops/pallas/mega.py:pack_runs": _PACK,
    "ops/pallas/mega.py:pack_mega": _PACK,
    "ops/pallas/mega.py:pack_mega16": _PACK,
    "ops/pallas/mega.py:pack_mega16_axes": _PACK,
    "ops/pallas/mega.py:pack_mega32": _PACK,
    "ops/pallas/mega.py:pack_mat16": _PACK,
    "ops/pallas/mega.py:pack_sub4": _PACK,
    "ops/pallas/mega.py:pack_sub4_axes": _PACK,
    "ops/pallas/mega.py:pack_palette": _PACK,
    "ops/pallas/mega.py:pack_compact_matw": _PACK,
    "ops/pallas/mega.py:set_voxel_tables16": _PACK,
    "ops/pallas/mega.py:set_voxel_tables32": _PACK,
    "ops/pallas/mega.py:set_voxel_mat16": _PACK,
    "ops/pallas/mega.py:set_voxel_occw3": _PACK,
    "ops/pallas/mega.py:set_voxel_sub4": _PACK,
    "ops/pallas/mega.py:set_voxel_sub4_axes": _PACK,
    "ops/pallas/mega.py:untile": "the port's kernels write image order: no tile order to undo",
    "ops/pallas/mega.py:AUX_SIGN_SHIFT": "JAX's own code stores axis * 2 + sign at bit 8 "
        "(the sign is bit 8, not 10); the port keeps the code's layout in AUX_AX_SHIFT",
    "ops/pallas/mega.py:LANES": _TILE,
    "ops/pallas/whitted.py:LANES": _TILE,
    "ops/pallas/coherent.py:TILE": _TILE,
    "ops/pallas/coherent.py:TILE_ROWS": _TILE,
    "ops/pallas/coherent.py:TILE_LANES": _TILE,
    "ops/pallas/mega.py:render_mega_tiles": _ARGS,
    "ops/pallas/mega.py:trace_rays": _ARGS,
    "ops/pallas/mega.py:render_mega": _ARGS,
    "ops/pallas/mega.py:render_lambert_mega": _ARGS,
    "ops/pallas/indep.py:render_indep_tiles": _ARGS,
    "ops/pallas/indep.py:trace_rays_indep": _ARGS,
    "ops/pallas/indep.py:render_indep": _ARGS,
    "ops/pallas/coherent.py:trace_coherent": _ARGS,
    "ops/pallas/diffint.py:integrate_fwd_tiles": _ARGS + " (rays as two (N, 3) arrays)",
    "ops/pallas/diffint.py:integrate_bwd_tiles": _ARGS + " (rays as two (N, 3) arrays)",
    "ops/pallas/diffint.py:occ_words": "takes brick-major sigma, not the TPU's packed rows",
    "ops/pallas/mega.py:MegaVolume.brick16_kw": _LAYOUT,
    "ops/pallas/mega.py:MegaVolume.brick32_kw": _LAYOUT,
    "ops/pallas/mega.py:MegaVolume.ensure_axes": _LAYOUT,
    "ops/pallas/mega.py:MegaVolume.ensure_sub_axes": _LAYOUT,
    "ops/pallas/mega.py:MegaVolume.mat16_fits_vmem": _LAYOUT,
    "ops/pallas/mega.py:MegaVolume.compact_matw": _LAYOUT,
    "ops/pallas/multi.py:MultiMegaIntersector.__init__": "compact_fracs sizes XLA's "
        "static compaction buckets; the port gathers each volume's slab-test rays exactly",
    "ops/diff_surface.py:render_lambert_surface_mega": "`interpret` runs Pallas on the "
        "CPU; a port wrapper takes its plain version for CPU tensors",
    "ops/dda.py:DdaState": "the XLA while-loop's carry; the port's loop keeps its state in locals",
    "parallel/mesh.py:ray_sharding": "a JAX NamedSharding; a port rank takes its block "
        "with mesh.shard_rays",
    "parallel/mesh.py:replicated": "a JAX NamedSharding; a port tensor is replicated as it is",
    "parallel/grid_train.py:render_grid_sharded": "runs inside shard_map in JAX, which no "
        "caller reaches from outside; the port takes the mesh explicitly, first",
    "utils/profiling.py:jax_trace": "the jax.profiler scope; the port's is trace()",
}


def _rel_port(rel: str) -> str:
    return rel.replace("ops/pallas/", "ops/cuda/", 1)


def _parse(path: pathlib.Path):
    return ast.parse(path.read_text(), filename=str(path))


def _public(name: str) -> bool:
    return not name.startswith("_")


def _upper(name: str) -> bool:
    return re.fullmatch(r"[A-Z][A-Z0-9_]*", name) is not None


def _positional(fn) -> list:
    return [a.arg for a in fn.args.posonlyargs + fn.args.args]


class _Module:
    """The top-level names of one file: functions and classes by node,
    constants by name, `from voxel_tracer_tpu_torch... import` names by
    (module path, name)."""

    def __init__(self, path: pathlib.Path, pkg: str):
        self.defs, self.consts, self.imports = {}, set(), {}
        for node in _parse(path).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                self.defs[node.name] = node
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            self.consts.add(n.id)
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.split(".")[0] == pkg:
                for a in node.names:
                    self.imports[a.asname or a.name] = (node.module, a.name)

    def names(self) -> set:
        return set(self.defs) | self.consts | set(self.imports)


_CACHE = {}


def _module(path: pathlib.Path, pkg: str) -> _Module:
    if path not in _CACHE:
        _CACHE[path] = _Module(path, pkg)
    return _CACHE[path]


def _resolve(path: pathlib.Path, name: str, pkg: str):
    """The def node that ``name`` in ``path`` is, following re-exports
    within the package; None for a constant or a name from elsewhere."""
    for _ in range(8):
        mod = _module(path, pkg)
        if name in mod.defs:
            return mod.defs[name]
        if name not in mod.imports:
            return None
        module, name = mod.imports[name]
        parts = module.split(".")
        path = ROOT.joinpath(*parts).with_suffix(".py")
        if not path.exists():
            path = ROOT.joinpath(*parts, "__init__.py")
    return None


def _methods(cls, path, pkg) -> dict:
    """Methods of a class node, its package-local bases' included."""
    out = {}
    for base in cls.bases:
        if isinstance(base, ast.Name):
            b = _resolve(path, base.id, pkg)
            if isinstance(b, ast.ClassDef):
                out.update(_methods(b, path, pkg))
    out.update({n.name: n for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))})
    return out


def _surface(rel: str):
    """(key, JAX node or None) for each public item of one JAX file:
    top-level functions and classes, public methods and __init__, UPPER
    constants."""
    path = JAX_PKG / rel
    mod = _module(path, "voxel_tracer_tpu")
    for name, node in mod.defs.items():
        if not _public(name):
            continue
        yield f"{rel}:{name}", node
        if isinstance(node, ast.ClassDef):
            for m, fn in _methods(node, path, "voxel_tracer_tpu").items():
                if _public(m) or m == "__init__":
                    yield f"{rel}:{name}.{m}", fn
    for name in sorted(mod.consts):
        if _upper(name):
            yield f"{rel}:{name}", None


JAX_FILES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _port_item(key: str):
    """The port's counterpart of one key: (found, def node or None)."""
    rel, name = key.split(":")
    path = PORT_PKG / _rel_port(rel)
    if not path.exists():
        return False, None
    top, _, meth = name.partition(".")
    mod = _module(path, "voxel_tracer_tpu_torch")
    if top not in mod.names():
        return False, None
    node = _resolve(path, top, "voxel_tracer_tpu_torch")
    if not meth:
        return True, node
    if not isinstance(node, ast.ClassDef):
        return False, None
    methods = _methods(node, path, "voxel_tracer_tpu_torch")
    if meth == "__init__" and meth not in methods:
        # a dataclass or NamedTuple: its generated constructor takes the
        # fields in order, as the JAX class's does
        return True, None
    return meth in methods, methods.get(meth)


def _item_problems(key: str, jnode) -> list:
    """What a JAX caller of ``key`` would miss in the port."""
    found, pnode = _port_item(key)
    if not found:
        return [f"{key}: no counterpart in the port"]
    fn = (ast.FunctionDef, ast.AsyncFunctionDef)
    if not (isinstance(jnode, fn) and isinstance(pnode, fn)):
        return []
    out = []
    jp, pp = _positional(jnode), _positional(pnode)
    if pp[:len(jp)] != jp:
        out.append(f"{key}: positional {pp} does not begin with JAX's {jp}")
    named = set(pp) | {a.arg for a in pnode.args.kwonlyargs}
    missing = [a.arg for a in jnode.args.kwonlyargs if a.arg not in named]
    if missing and pnode.args.kwarg is None:
        out.append(f"{key}: takes no keyword {missing}")
    return out


@pytest.mark.parametrize("rel", JAX_FILES)
def test_port_carries_the_jax_surface(rel):
    assert (PORT_PKG / _rel_port(rel)).exists(), f"no port file for {rel}"
    problems = [p for key, jnode in _surface(rel) if key not in NOT_OWED
                for p in _item_problems(key, jnode)]
    assert not problems, "\n".join(problems)


def test_not_owed_names_exist_in_the_jax_package():
    """Every NOT_OWED key names a public item of the JAX package, and has
    a reason."""
    keys = {key for rel in JAX_FILES for key, _ in _surface(rel)}
    stale = sorted(k for k in NOT_OWED if k not in keys)
    assert not stale, f"NOT_OWED names nothing in the JAX package: {stale}"
    assert all(isinstance(v, str) and v.strip() for v in NOT_OWED.values())


def test_not_owed_names_only_what_differs():
    """Every NOT_OWED entry excuses a difference that is still there: an
    item that the port now carries leaves the list."""
    items = {key: jnode for rel in JAX_FILES for key, jnode in _surface(rel)}
    carried = sorted(k for k in NOT_OWED if k in items and not _item_problems(k, items[k]))
    assert not carried, f"the port carries these; take them out of NOT_OWED: {carried}"
