"""The port holds every public name of proton_tpu, read with ``ast`` from
both packages' sources (nothing is imported, JAX least of all):

- every module of ``proton_tpu/`` has its counterpart in
  ``proton_tpu_torch/`` (``methods/pallas_assembly.py``, the Pallas kernel
  K1, maps to ``methods/fused_assembly.py`` and ``csrc/fused_assembly.cu``);
- every public top-level name of a module (defs, classes, module
  assignments, and for ``__init__.py`` the names it imports) is in its
  counterpart;
- every parameter of a public top-level function, and of a public method
  of a public top-level class, is in the counterpart's signature;
- module constants that are literals in both packages are equal;
- the flags of every app are a subset of its port's.

What is not ported on purpose is NOT_PORTED, each entry with its reason
(the headings of ROADMAP.md's "Not ported, on purpose"). An entry that the
port has gained fails the test, so the list cannot go stale.

Run it with ``python -m pytest tests/test_torch_parity.py -q``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "proton_tpu"
PORT_PKG = ROOT / "proton_tpu_torch"

TPU = "TPU tiling and remote-compile workarounds"
SWITCH = "Pallas and precision switches"
UNUSED = "Layouts and helpers that no path calls"
REPLACED = "Replaced by the port's own form of the same data"
REASONS = (TPU, SWITCH, UNUSED, REPLACED)

# What the port leaves out on purpose: "module" (a whole module),
# "module.name" (a top-level name) or "module.function(parameter)", with
# modules named as dotted paths inside the package.
NOT_PORTED = {
    "config.MATMUL_PRECISION": SWITCH,
    "config.default_real_dtype": SWITCH,
    "config.default_int_dtype": SWITCH,
    "config.np_real_dtype": SWITCH,
    "solvers.multigrid.MGDataCL": TPU,
    "solvers.multigrid.mg_setup_cl": TPU,
    "solvers.multigrid.mg_precondition_cl": TPU,
    "solvers.multigrid.make_prolongation": UNUSED,
    "solvers.multigrid.make_reconstruction_prolongation": UNUSED,
    "solvers.multigrid.build_multigrid(layout)": UNUSED,
    "solvers.multigrid.build_multigrid(domain)": UNUSED,
    "solvers.multigrid.make_band_deflation(chunk)": TPU,
    "methods.cells_last.zeros_grid_cl": UNUSED,
    "methods.cells_last.irregular_face_indices": UNUSED,
    "methods.cells_last.uniform_bj_corrections": UNUSED,
    "methods.cells_last.apply_cut_patch_cl(cut_ids)": REPLACED,
    "methods.poisson.assemble_local_chunked": TPU,
    "cut.fictdom_structured.build_coarse_level": TPU,
    "cut.fictdom_structured.cut64_condensed_cached": TPU,
    "cut.fictdom_structured.mg_setup_cached": TPU,
    "cut.fictdom_structured.segments_can_reuse": TPU,
    "cut.fictdom_structured.segments_static": TPU,
    "cut.fictdom_structured.solve_chunked": TPU,
    "cut.fictdom_structured.solve_segments": TPU,
    "cut.fictdom_structured.uniform_static": TPU,
    "cut.fictdom_structured.build_level(use_pallas)": SWITCH,
    "cut.fictdom_structured.build_level(assemble_on)": SWITCH,
    "cut.fictdom_structured.solve_fictdom_structured(use_pallas)": SWITCH,
    "cut.fictdom_structured.band_galerkin_levels(problem)": TPU,
    "cut.fictdom_structured.band_galerkin_levels(eta)": TPU,
    "cut.fictdom_structured.band_galerkin_levels(int_refsteps)": TPU,
    "core.mesh.structured_topology_device": TPU,
    "parallel.halo.ROW_AXIS": REPLACED,
    "parallel.halo.make_row_mesh": REPLACED,
    "parallel.sharding.CELL_AXIS": REPLACED,
    "parallel.sharding.make_device_mesh(devices)": REPLACED,
    "parallel.sharding.pad_cells_to_multiple(mesh_arrays)": REPLACED,
    "methods.structured.make_structured_system(dtype)": REPLACED,
    "io.vtk.dump_sparse_matrix(bcoo)": REPLACED,
    "utils.debug.enable_nan_debugging": SWITCH,
    "utils.timing.phase": UNUSED,
    "methods.pallas_assembly.BLK": SWITCH,
    "methods.pallas_assembly.fused_local_operator(interpret)": SWITCH,
    "methods.pallas_assembly.fitted_local_operator(interpret)": SWITCH,
    "methods.pallas_assembly.fused_local_operator(cells_last)": REPLACED,
    "native_bindings": SWITCH,
}

# JAX module -> the port's files that hold it, where the path differs.
RENAMED = {"methods/pallas_assembly.py": ("methods/fused_assembly.py",
                                          "csrc/fused_assembly.cu")}


def _dotted(rel: str) -> str:
    """'cut/fictdom_structured.py' -> 'cut.fictdom_structured'."""
    parts = Path(rel).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts) \
        or "__init__"


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _public(name: str) -> bool:
    return not name.startswith("_") or (name.startswith("__") and
                                        name.endswith("__"))


def _targets(node):
    """Names a module-level statement binds."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return [node.name]
    if isinstance(node, ast.Assign):
        return [n.id for t in node.targets for n in ast.walk(t)
                if isinstance(n, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def _imports(node):
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        return [(a.asname or a.name).split(".")[0] for a in node.names]
    return []


def _toplevel(tree):
    """The statements at module level, those under a module-level ``if`` or
    ``try`` included (a guarded import or definition is still a name)."""
    out = []
    for node in tree.body:
        if isinstance(node, (ast.If, ast.Try)):
            out.extend(_toplevel(ast.Module(
                body=node.body + node.orelse + getattr(node, "finalbody", [])
                + [s for h in getattr(node, "handlers", []) for s in h.body],
                type_ignores=[])))
        else:
            out.append(node)
    return out


def _names(tree, with_imports):
    names = set()
    for node in _toplevel(tree):
        names.update(_targets(node))
        if with_imports:
            names.update(_imports(node))
    return names


def _functions(tree):
    """{name: FunctionDef} of the module's top-level functions and
    {"Class.method": FunctionDef} of its classes' methods."""
    out = {}
    for node in _toplevel(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{item.name}"] = item
    return out


def _params(fn):
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    names += [p.arg for p in (a.vararg, a.kwarg) if p is not None]
    return names


def _constants(tree):
    """{name: value} of module-level NAME = <literal> assignments."""
    out = {}
    for node in _toplevel(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def _port_files(rel):
    return [PORT_PKG / p for p in RENAMED.get(rel, (rel,))]


def _missing(rel):
    """(what the port lacks of JAX module ``rel``, the constants whose
    literals differ), each as NOT_PORTED keys."""
    mod = _dotted(rel)
    jtree = _tree(JAX_PKG / rel)
    ptree = _tree(_port_files(rel)[0])
    is_init = rel.endswith("__init__.py")
    have = _names(ptree, with_imports=True)
    lacking = [f"{mod}.{n}" for n in sorted(_names(jtree, is_init))
               if _public(n) and n not in have]
    pfuncs = _functions(ptree)
    for qual, fn in sorted(_functions(jtree).items()):
        if not all(_public(p) for p in qual.split(".")) or \
                qual.endswith("__init__"):
            continue
        if qual not in pfuncs:
            lacking.append(f"{mod}.{qual}")
            continue
        theirs = set(_params(pfuncs[qual]))
        lacking += [f"{mod}.{qual}({p})" for p in _params(fn)
                    if p not in theirs]
    jconst, pconst = _constants(jtree), _constants(ptree)
    unequal = [f"{mod}.{n}" for n in sorted(set(jconst) & set(pconst))
               if _public(n) and jconst[n] != pconst[n]]
    return lacking, unequal


@pytest.mark.parametrize("rel", _jax_modules())
def test_module_is_ported(rel):
    """The counterpart of JAX module ``rel`` exists and holds its public
    names and parameters, or NOT_PORTED lists them; literal constants are
    equal in both."""
    mod = _dotted(rel)
    if mod in NOT_PORTED:
        return
    for path in _port_files(rel):
        assert path.is_file(), f"{rel}: no {path.relative_to(ROOT)}"
    lacking, unequal = _missing(rel)
    assert [k for k in lacking if k not in NOT_PORTED] == [], \
        "in proton_tpu, not in the port nor in NOT_PORTED"
    assert unequal == [], "constants that differ"


def _port_has(key):
    """Whether the port holds NOT_PORTED entry ``key``."""
    head, _, param = key.partition("(")
    mods = {_dotted(rel): rel for rel in _jax_modules()}
    if key in mods:
        return all(p.exists() for p in _port_files(mods[key]))
    owners = [m for m in mods if head.startswith(m + ".")]
    assert owners, f"{key}: names no module of proton_tpu"
    mod = max(owners, key=len)
    name = head[len(mod) + 1:]
    jtree, ptree = _tree(JAX_PKG / mods[mod]), _tree(_port_files(mods[mod])[0])
    if not param:
        if "." in name:
            assert name in _functions(jtree), key
            return name in _functions(ptree)
        assert name in _names(jtree, with_imports=True), key
        return name in _names(ptree, with_imports=True)
    param = param.rstrip(")")
    assert param in _params(_functions(jtree)[name]), key
    fn = _functions(ptree).get(name)
    return fn is not None and param in _params(fn)


@pytest.mark.parametrize("key", sorted(NOT_PORTED))
def test_not_ported_is_not_in_the_port(key):
    """Each NOT_PORTED entry carries one of ROADMAP's reasons, names
    something of proton_tpu, and is still absent from the port."""
    assert NOT_PORTED[key] in REASONS
    assert not _port_has(key), f"{key} is ported: drop it from NOT_PORTED"


def _flags(path: Path):
    flags = set()
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", None) == "add_argument":
            flags.update(a.value for a in node.args
                         if isinstance(a, ast.Constant) and
                         str(a.value).startswith("-"))
    return flags


@pytest.mark.parametrize("app", sorted(
    p.name for p in (JAX_PKG / "apps").glob("*.py")
    if p.name != "__init__.py"))
def test_app_takes_every_flag(app):
    """The port's app takes every flag of the JAX app (the stabilization
    test takes none)."""
    jflags, flags = _flags(JAX_PKG / "apps" / app), \
        _flags(PORT_PKG / "apps" / app)
    assert "--device" in flags
    assert jflags <= flags, sorted(jflags - flags)
