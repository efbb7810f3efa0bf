"""The JAX package's references for the port's tests (imported by
tests/test_torch_*.py; collects no test of its own), and the command that
stores them.

- **The store.** A JAX computation of a port test that costs more than
  about 2 s is not run by the test: the test reads its outputs from
  ``tests/jax_refs/<test module>.npz`` (``np.savez_compressed``, no
  pickle) through ``jax_ref(module, key)`` or the module's ``Refs``.
  A test module declares each such computation once, with
  ``REFS = Refs(__name__)`` and ``REFS.add(key, kind, call, fn, ...)``:
  ``fn`` runs the JAX package alone on the test's seeded inputs and
  returns what the test's assertions read, in the dtype JAX returns.
  ``tests/jax_refs/manifest.json`` records for each entry the JAX call as
  text, its arguments, its seed and its fields, and for each module the
  sha256 of the JAX package's sources (every ``proton_tpu/**/*.py`` in
  sorted path order) and the jax, jaxlib and numpy versions it was made
  with. The reader raises ``StaleStore``, naming the command that
  regenerates the store, when either differs from this tree's: there is
  no fallback to a live computation and no stale reference. Reading
  imports no JAX (the spawned ranks of tests/test_torch_parallel.py
  import their module without it).
- **The command.** ``python tests/torch_jax_reference.py --write
  [module ...] [--jobs J]`` recomputes the entries of the modules named
  (all by default), one process per module, ``J`` at a time, with XLA on
  one thread. ``--out DIR`` writes the store elsewhere
  (tests/test_torch_jax_refs.py::test_store_regenerates compares such a
  copy with the committed one); ``--recompute MODULE KEY --out FILE``
  computes one entry again the same way.
- ``jax_transfer_builders`` memoizes the JAX package's own multigrid
  transfer builders (``_transfer_slot_matrices``,
  ``_transfer_face_projectors``, ``_unit_recmap``: pure functions of the
  degree, the cell side and the dtype, which its multigrid setup calls
  again for every level and hierarchy), each run once under jax.jit.
- ``jax_solve`` is the JAX package's ``solve_fictdom_structured`` from its
  levels on: the keywords it gives its ``_solve_jit``, then its chunked H1
  error.
"""

import argparse
import dataclasses
import functools
import hashlib
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
STORE = os.path.join(TESTS, "jax_refs")
COMMAND = "python tests/torch_jax_reference.py --write"
# XLA on one thread while the store is written, so that a rewrite gives
# the same bits; the 8 host devices of tests/conftest.py.
GENERATOR_XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
                       "--xla_cpu_multi_thread_eigen=false "
                       "intra_op_parallelism_threads=1")
TRANSFER_BUILDERS = ("_transfer_slot_matrices", "_transfer_face_projectors",
                     "_unit_recmap")


# ---------------------------------------------------------------------------
# The store: stamp, reader
# ---------------------------------------------------------------------------


class StaleStore(RuntimeError):
    """The stored references do not belong to this tree."""


@functools.lru_cache(maxsize=None)
def source_sha256() -> str:
    """sha256 over every proton_tpu/**/*.py in sorted path order: each
    file's path relative to the repo, a NUL, its bytes, a NUL."""
    h = hashlib.sha256()
    paths = []
    for d, _, files in os.walk(os.path.join(ROOT, "proton_tpu")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    for p in sorted(os.path.relpath(p, ROOT) for p in paths):
        h.update(p.replace(os.sep, "/").encode() + b"\0")
        with open(os.path.join(ROOT, p), "rb") as f:
            h.update(f.read() + b"\0")
    return h.hexdigest()


def versions() -> dict:
    from importlib.metadata import version
    return {"jax": version("jax"), "jaxlib": version("jaxlib"),
            "numpy": np.__version__}


def stamp() -> dict:
    return {"source_sha256": source_sha256(), "versions": versions()}


def digest(*arrays) -> str:
    """sha256 of arrays (tensors or numpy; dtype, shape and bytes): the
    fingerprint of a reference's inputs that the port computes."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a.detach().cpu().numpy()
                                 if hasattr(a, "detach") else np.asarray(a))
        h.update(f"{a.dtype.str}{a.shape}".encode() + a.tobytes())
    return h.hexdigest()


class Node:
    """A stored structure, read back: fields by attribute, by name or by
    position (``node.cond.dS``, ``node["16"]``, ``node[16]``, ``node[1:]``,
    ``a, b = node``), leaves as numpy arrays and 0-d leaves as Python
    scalars."""

    def __init__(self, items):
        self._items = dict(items)

    @property
    def _fields(self):
        return tuple(self._items)

    def __getattr__(self, name):
        try:
            return self.__dict__["_items"][name]
        except KeyError:
            raise AttributeError(name) from None

    def __getitem__(self, key):
        if str(key) in self._items:
            return self._items[str(key)]
        if isinstance(key, (int, slice)):
            return list(self._items.values())[key]
        raise KeyError(key)

    def __iter__(self):
        return iter(self._items.values())

    def __len__(self):
        return len(self._items)

    def items(self):
        return self._items.items()

    def __repr__(self):
        return f"Node({', '.join(self._items)})"


def _leaf(a):
    return a.item() if a.ndim == 0 else a


def _unflatten(fields: dict, arrays: dict):
    """{path: array or None} in stored order -> the structure (a bare
    leaf where the entry stored one array at path '')."""
    if list(fields) == [""]:
        return None if arrays.get("") is None else _leaf(arrays[""])
    root: dict = {}
    for path in fields:
        node, *parts = [root] + path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = None if fields[path] is None else \
            _leaf(arrays[path])

    def build(d):
        return Node((k, build(v) if isinstance(v, dict) else v)
                    for k, v in d.items())
    return build(root)


@functools.lru_cache(maxsize=None)
def _manifest(store=STORE):
    path = os.path.join(store, "manifest.json")
    if not os.path.exists(path):
        raise StaleStore(f"{path} is missing. Write the store with: "
                         f"{COMMAND}")
    with open(path) as f:
        return json.load(f)


@functools.lru_cache(maxsize=None)
def _arrays(module, store=STORE):
    with np.load(os.path.join(store, f"{module}.npz"),
                 allow_pickle=False) as z:
        return {name: z[name] for name in z.files}


def check_module(module, store=STORE):
    """The manifest's section of ``module``, if it matches this tree's
    JAX sources and versions; else StaleStore with the command."""
    section = _manifest(store)["modules"].get(module)
    if section is None:
        raise StaleStore(f"tests/jax_refs holds nothing for {module}. "
                         f"Write it with: {COMMAND} {module}")
    now = stamp()
    for what in ("source_sha256", "versions"):
        if section[what] != now[what]:
            raise StaleStore(
                f"tests/jax_refs/{module}.npz was made with {what} "
                f"{section[what]}, this tree has {now[what]}. Regenerate "
                f"the store with: {COMMAND}")
    return section


def jax_ref(module, key, inputs=None, store=STORE):
    """The stored JAX reference ``key`` of test module ``module``. With
    ``inputs`` (arrays the port computed for the JAX call), their digest
    must be the one stored with it."""
    module = module.rsplit(".", 1)[-1]
    entry = check_module(module, store)["entries"].get(key)
    if entry is None:
        raise StaleStore(f"tests/jax_refs/{module}.npz has no entry {key!r}."
                         f" Write it with: {COMMAND} {module}")
    if inputs is not None and digest(*inputs) != entry["inputs_sha256"]:
        raise StaleStore(
            f"{module} {key!r}: the port's inputs to the JAX call differ "
            f"from those it was stored with. Regenerate it with: "
            f"{COMMAND} {module}")
    data = _arrays(module, store)
    return _unflatten(entry["fields"],
                      {p: data[f"{key}|{p}"] for p, v in
                       entry["fields"].items() if v is not None})


# ---------------------------------------------------------------------------
# The store: declaring and writing entries
# ---------------------------------------------------------------------------


def _flatten(obj, path, out):
    """Appends (path, numpy array or None) for every leaf of ``obj``."""
    if obj is None:
        out.append((path, None))
        return
    if hasattr(obj, "__array__") or isinstance(obj, (bool, int, float,
                                                     str)):
        a = np.asarray(obj)
        if a.dtype == object:
            raise TypeError(f"{path}: an object array cannot be stored")
        out.append((path, a))
        return
    join = (lambda k: f"{path}.{k}") if path else str
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        items = zip(obj._fields, obj)
    elif dataclasses.is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    elif isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (tuple, list)):
        items = enumerate(obj)
    elif hasattr(obj, "__dict__") and not callable(obj):
        items = vars(obj).items()
    else:
        raise TypeError(f"{path}: cannot store a {type(obj).__name__}")
    for k, v in items:
        if "." in str(k) or "|" in str(k):
            raise ValueError(f"{path}: field name {k!r}")
        _flatten(v, join(k), out)


@dataclasses.dataclass
class Entry:
    kind: str       # "level", "vcycle", "solve", or what else it computes
    call: str       # the JAX call, as text
    fn: object      # fn(*needed entries, **args) -> what the test reads
    args: dict
    seed: object    # the numpy seed of the inputs, or None
    needs: tuple    # keys of earlier entries fn takes, as stored


class Refs:
    """The stored JAX references of one test module:
    ``REFS.add(key, kind, call, fn, needs=(), seed=None, **args)``
    declares one, ``REFS[key]`` (or ``REFS.get(key, inputs=...)``)
    reads it."""

    def __init__(self, module):
        self.module = module.rsplit(".", 1)[-1]
        self.entries: dict = {}

    def add(self, key, kind, call, fn, needs=(), seed=None, **args):
        assert key not in self.entries and "|" not in key, key
        assert all(n in self.entries for n in needs), needs
        self.entries[key] = Entry(kind, call, fn, args, seed, tuple(needs))

    def __getitem__(self, key):
        return jax_ref(self.module, key)

    def get(self, key, inputs=None):
        return jax_ref(self.module, key, inputs)

    def compute(self, key, stored=None):
        """Runs entry ``key`` now: (its flattened fields, the digest of its
        inputs or None). Its needed entries come from ``stored`` ({key:
        Node}), else from the committed store."""
        e = self.entries[key]
        needed = [stored[n] if stored is not None else self[n]
                  for n in e.needs]
        value = e.fn(*needed, **e.args)
        inputs = None
        if isinstance(value, dict) and "inputs" in value:
            value = dict(value)
            inputs = digest(*value.pop("inputs"))
        flat = []
        _flatten(value, "", flat)
        return flat, inputs


def write_module(module, store=STORE):
    """Computes every entry of ``module`` and writes its npz; returns its
    manifest section."""
    refs = importlib.import_module(module).REFS
    section = dict(stamp(), seconds=0.0, entries={})
    arrays, stored = {}, {}
    t_module = time.perf_counter()
    with _generator_state():
        for key, e in refs.entries.items():
            t0 = time.perf_counter()
            flat, inputs = refs.compute(key, stored)
            seconds = time.perf_counter() - t0
            fields = {p: (None if a is None else [a.dtype.str,
                                                  list(a.shape)])
                      for p, a in flat}
            stored[key] = _unflatten(fields, {p: a for p, a in flat})
            arrays.update({f"{key}|{p}": a for p, a in flat
                           if a is not None})
            section["entries"][key] = dict(
                kind=e.kind, call=e.call, args=_jsonable(e.args),
                seed=e.seed, needs=list(e.needs),
                seconds=round(seconds, 2), fields=fields,
                **({"inputs_sha256": inputs} if inputs else {}))
            print(f"{module} {key}: {seconds:.1f} s", flush=True)
    section["seconds"] = round(time.perf_counter() - t_module, 1)
    os.makedirs(store, exist_ok=True)
    np.savez_compressed(os.path.join(store, f"{module}.npz"), **arrays)
    return section


def _jsonable(args):
    return json.loads(json.dumps(args, default=repr))


class _generator_state:
    """The test modules' thread settings (BLAS and torch on one thread)
    and the JAX package's own transfer builders, memoized."""

    def __enter__(self):
        import pytest
        import threadpoolctl
        import torch
        self._mp = pytest.MonkeyPatch()
        jax_transfer_builders(self._mp)
        self._limits = threadpoolctl.threadpool_limits(1)
        self._threads = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        import torch
        torch.set_num_threads(self._threads)
        self._limits.unregister()
        self._mp.undo()


def stored_modules():
    """The port test modules that declare stored references."""
    out = []
    for name in sorted(os.listdir(TESTS)):
        if name.startswith("test_torch_") and name.endswith(".py"):
            with open(os.path.join(TESTS, name)) as f:
                if "\nREFS = Refs(" in f.read():
                    out.append(name[:-3])
    return out


def _generator_env():
    return dict(os.environ, XLA_FLAGS=GENERATOR_XLA_FLAGS,
                PYTHONPATH=os.pathsep.join(
                    p for p in (ROOT, TESTS, os.environ.get("PYTHONPATH"))
                    if p))


def recompute(entries, out_dir):
    """Computes the entries ``(module, key)`` again, each in a process of
    its own set up as the store's writer is (all at once), from the
    committed store's needed entries; returns {(module, key): [(path,
    array or None)]}."""
    entries = list(entries)
    paths = [os.path.join(out_dir, f"{i}.npz") for i in range(len(entries))]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--recompute", module, key, "--out", path],
                              env=_generator_env(), cwd=ROOT)
             for (module, key), path in zip(entries, paths)]
    assert [p.wait() for p in procs] == [0] * len(procs), entries
    out = {}
    for entry, path in zip(entries, paths):
        with np.load(path, allow_pickle=False) as z:
            out[entry] = [(p, z[p] if p in z.files else None)
                          for p in json.loads(str(z["__paths__"]))]
    return out


def _recompute_one(module, key, path):
    refs = importlib.import_module(module).REFS
    with _generator_state():
        flat, _ = refs.compute(key)
    np.savez(path, __paths__=np.asarray(json.dumps([p for p, _ in flat])),
             **{p: a for p, a in flat if a is not None})


def write(modules=None, store=STORE, jobs=1):
    """Rewrites the entries of ``modules`` (all by default) under
    ``store``, one process per module, ``jobs`` at a time, and merges
    their sections into the manifest."""
    modules = list(modules or stored_modules())
    sections = {}
    env = _generator_env()
    with tempfile.TemporaryDirectory() as tmp:
        pending, running, failed = list(modules), [], []
        while pending or running:
            while pending and len(running) < jobs:
                m = pending.pop(0)
                running.append((m, subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--module",
                     m, "--out", store, "--section",
                     os.path.join(tmp, f"{m}.json")], env=env, cwd=ROOT)))
            for m, proc in list(running):
                if proc.poll() is not None:
                    running.remove((m, proc))
                    if proc.returncode:
                        failed.append(m)
                    else:
                        with open(os.path.join(tmp, f"{m}.json")) as f:
                            sections[m] = json.load(f)
            time.sleep(0.5)
    _merge(store, sections)
    if failed:
        raise SystemExit(f"failed: {' '.join(failed)}")


def _merge(store, sections):
    """Puts ``sections`` into the store's manifest (under a lock: two
    writes may run at once)."""
    import fcntl
    os.makedirs(store, exist_ok=True)
    path = os.path.join(store, "manifest.json")
    lock = os.open(store, os.O_RDONLY)
    try:
        fcntl.flock(lock, fcntl.LOCK_EX)
        manifest = {"command": COMMAND, "modules": {}}
        if os.path.exists(path):
            with open(path) as f:
                manifest = json.load(f)
        manifest["modules"].update(sections)
        manifest["modules"] = dict(sorted(manifest["modules"].items()))
        with open(path, "w") as f:
            json.dump(manifest, f, indent=1)
            f.write("\n")
    finally:
        os.close(lock)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--write", nargs="*", metavar="MODULE",
                   help="rewrite these test modules' entries (all if none)")
    p.add_argument("--jobs", type=int, default=1)
    p.add_argument("--out", default=STORE)
    p.add_argument("--module", help=argparse.SUPPRESS)
    p.add_argument("--section", help=argparse.SUPPRESS)
    p.add_argument("--recompute", nargs=2, metavar=("MODULE", "KEY"),
                   help="compute one entry again into the npz --out")
    a = p.parse_args(argv)
    if a.recompute:
        _recompute_one(*a.recompute, a.out)
    elif a.module:
        section = write_module(a.module, a.out)
        with open(a.section, "w") as f:
            json.dump(section, f)
    elif a.write is not None:
        write(a.write, a.out, a.jobs)
    else:
        p.print_help()


# ---------------------------------------------------------------------------
# The JAX package's transfer builders, memoized; its solve from its levels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _own_builders():
    """The JAX package's own transfer builders, taken before any patch."""
    from proton_tpu.solvers import multigrid as jmg
    own = {name: getattr(jmg, name) for name in TRANSFER_BUILDERS}
    assert all(f.__module__ == jmg.__name__ for f in own.values()), own
    return own


@functools.lru_cache(maxsize=None)
def jax_transfer_arrays(name, hdi, h, dtype=None):
    """The JAX package's own transfer builder ``name`` at (hdi, h[,
    dtype]), compiled with jax.jit, as numpy."""
    import jax
    args = (hdi, h) if dtype is None else (hdi, h, dtype)
    out = jax.jit(_own_builders()[name],
                  static_argnums=tuple(range(len(args))))(*args)
    return jax.tree.map(np.asarray, out)


def _memoized(name):
    """The builder ``name`` answered from jax_transfer_arrays: computed
    outside any trace, and returned as fresh JAX arrays each call, so
    that none is cached inside a trace."""
    import jax
    import jax.numpy as jnp

    def fn(hdi, h, dtype=None):
        with jax.ensure_compile_time_eval():
            out = jax_transfer_arrays(
                name, hdi, float(h),
                jnp.dtype(dtype).name
                if name == "_transfer_slot_matrices" else None)
        if isinstance(out, tuple):
            return tuple(jnp.asarray(a, dtype) for a in out)
        return jnp.asarray(out, dtype)
    return fn


def jax_transfer_builders(mp):
    """Patch (with the MonkeyPatch ``mp``) the JAX package's transfer
    builders to themselves, memoized and run under jax.jit."""
    from proton_tpu.solvers import multigrid as jmg
    _own_builders()
    for name in TRANSFER_BUILDERS:
        mp.setattr(jmg, name, _memoized(name))


def jax_solve(levels, degree, cg_params, *, problem=None, precond="mg",
              mg_coarsest=8, n_smooth=1, patch_ring=1, patch_colors=1,
              mg_f32=False, mg_smoother="chebyshev", cheb_degree=4,
              cheb_ops="exact", patch_sweeps=1, cg_f64=None,
              mg_transfer="uniform", mg_deflate=0):
    """The JAX package's solve_fictdom_structured(N, degree, ...) over
    ``levels`` ({n: LevelData} as its build_level / build_coarse_level
    return them; the largest n is the fine level, with its right-hand
    side), with the same keywords and defaults. Returns (local,
    iterations, exit code, relative residual, H1 error)."""
    import jax
    from proton_tpu.core.geometry import cell_geometry as jcell_geometry
    from proton_tpu.core.ops import HHODegreeInfo as JHHODegreeInfo
    from proton_tpu.cut import fictdom_structured as jfs
    from proton_tpu.methods import assembly as jassembly
    from proton_tpu.methods import cells_last as jcl

    problem = problem or jfs.default_problem()
    hdi = JHHODegreeInfo(degree + 1, degree)
    N = max(levels)
    fine = levels[N]
    sizes = tuple(sorted(levels))
    assert sizes == tuple(sorted(jfs._mg_sizes(N, mg_coarsest)
                                 if precond == "mg" else [N]))
    kw = dict(
        sizes=sizes, hdi=hdi, problem=problem, precond=precond,
        cut_levels=tuple(
            (n, tuple(int(i) for i in
                      jfs.expand_ring(levels[n].cut_ids, n, patch_ring)))
            for n in sizes),
        mg_coarsest=mg_coarsest, n_smooth=n_smooth, mg_f32=mg_f32,
        mg_smoother=mg_smoother, cheb_degree=cheb_degree,
        patch_colors=patch_colors, cheb_ops=cheb_ops,
        patch_sweeps=patch_sweeps,
        smooth_transfers=mg_transfer == "smoothed",
        deflate_K=mg_deflate, mg_gamma=1,
        uniform_levels=jfs.uniform_static(levels),
        cg_f64=(jax.config.jax_enable_x64 and not mg_f32
                if cg_f64 is None else cg_f64))
    drec_list = None
    if precond == "mg" and mg_transfer == "cut":
        dl = tuple(levels[n].drec for n in sizes)
        if any(d is not None for d in dl):
            drec_list = dl
    S = tuple(levels[n].cond.dS if isinstance(levels[n].cond,
                                              jcl.UniformCondCL)
              else levels[n].cond.S for n in sizes)
    local, _, iters, exit_reason, rel, _ = jfs._solve_jit(
        fine.mesh, jassembly.build_dofmap_structured(N, hdi), fine.cond, S,
        cg_params=cg_params, drec_list=drec_list, gal_list=None, **kw)
    h1 = jfs.fictdom_h1_error_chunked(
        fine.mesh, jax.jit(jcell_geometry)(fine.mesh), fine.batch,
        fine.cell_loc, hdi, local, problem.sol_grad)
    return local, int(iters), int(exit_reason), float(rel), float(h1)


SOLVE_FIELDS = ("local", "iterations", "exit_reason", "rel_residual", "h1")


def jax_solve_ref(levels, degree, cg_params, keep=SOLVE_FIELDS, **kw):
    """jax_solve as a stored entry: the fields ``keep`` of {local,
    iterations, exit_reason, rel_residual, h1}, in jax_solve's order."""
    out = dict(zip(SOLVE_FIELDS, jax_solve(levels, degree, cg_params, **kw)))
    return {k: out[k] for k in SOLVE_FIELDS if k in keep}


if __name__ == "__main__":
    # the writer's XLA settings and the test suite's JAX configuration
    # (tests/conftest.py), before JAX starts
    os.environ["XLA_FLAGS"] = GENERATOR_XLA_FLAGS
    sys.path[:0] = [ROOT]
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import torch_jax_reference
    torch_jax_reference.main()
