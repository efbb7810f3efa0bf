"""The JAX package's references for the port's tests, computed cheaply
(imported by tests/test_torch_*.py; collects no test of its own).

- ``jax_transfer_builders`` memoizes the JAX package's multigrid
  transfer builders (``_transfer_slot_matrices``,
  ``_transfer_face_projectors``, ``_unit_recmap``; pure functions of the
  degree, the cell side and the dtype), which its multigrid setup calls
  again for every level and hierarchy: an eager call costs 5-15 s of
  compiling one primitive at a time, a jitted one 2-17 s. By default they
  answer with the port's arrays, which
  tests/test_torch_multigrid_transfers.py holds to the JAX package's own
  to 1e-12 (that module runs the JAX package's own, ``own=True``).
- ``jax_solve`` is the JAX package's ``solve_fictdom_structured`` from its
  levels on: the keywords it gives its ``_solve_jit``, then its chunked H1
  error. A module builds its JAX levels once (``jfs.build_level``,
  ``jfs.build_coarse_level``) and solves them as often as its cases need.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from proton_tpu.core.geometry import cell_geometry as jcell_geometry
from proton_tpu.core.ops import HHODegreeInfo as JHHODegreeInfo
from proton_tpu.cut import fictdom_structured as jfs
from proton_tpu.methods import assembly as jassembly
from proton_tpu.methods import cells_last as jcl
from proton_tpu.solvers import multigrid as jmg
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.solvers import multigrid

TRANSFER_BUILDERS = ("_transfer_slot_matrices", "_transfer_face_projectors",
                     "_unit_recmap")
_OWN = {name: getattr(jmg, name) for name in TRANSFER_BUILDERS}


@functools.lru_cache(maxsize=None)
def jax_transfer_arrays(name, hdi, h, dtype=None):
    """The JAX package's own transfer builder ``name`` at (hdi, h[,
    dtype]), compiled with jax.jit, as numpy."""
    args = (hdi, h) if dtype is None else (hdi, h, dtype)
    out = jax.jit(_OWN[name], static_argnums=tuple(range(len(args))))(*args)
    return jax.tree.map(np.asarray, out)


@functools.lru_cache(maxsize=None)
def port_transfer_arrays(name, cell_degree, face_degree, h):
    """The port's transfer builder ``name`` at (degree, h), float64, as
    numpy."""
    hdi = HHODegreeInfo(cell_degree, face_degree)
    fn = getattr(multigrid, name)
    out = fn(hdi, h, torch.float64, device="cpu") \
        if name == "_transfer_slot_matrices" else fn(hdi, h, device="cpu")
    return tuple(a.numpy() for a in out) if isinstance(out, tuple) \
        else out.numpy()


def _memoized(name, own):
    """The builder ``name`` answered from jax_transfer_arrays (``own``)
    or port_transfer_arrays: computed outside any trace, and returned as
    fresh JAX arrays each call, so that none is cached inside a trace."""
    def fn(hdi, h, dtype=None):
        if own:
            with jax.ensure_compile_time_eval():
                out = jax_transfer_arrays(
                    name, hdi, float(h),
                    jnp.dtype(dtype).name
                    if name == "_transfer_slot_matrices" else None)
        else:
            out = port_transfer_arrays(name, hdi.cell_degree,
                                       hdi.face_degree, float(h))
        if isinstance(out, tuple):
            return tuple(jnp.asarray(a, dtype) for a in out)
        return jnp.asarray(out, dtype)
    return fn


def jax_transfer_builders(mp, own=False):
    """Patch (with the MonkeyPatch ``mp``) the JAX package's transfer
    builders: with ``own``, to themselves memoized and run under jax.jit;
    else to answer with the port's arrays."""
    for name in TRANSFER_BUILDERS:
        mp.setattr(jmg, name, _memoized(name, own))


def _S(lev):
    return lev.cond.dS if isinstance(lev.cond, jcl.UniformCondCL) \
        else lev.cond.S


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
    local, _, iters, exit_reason, rel, _ = jfs._solve_jit(
        fine.mesh, jassembly.build_dofmap_structured(N, hdi), fine.cond,
        tuple(_S(levels[n]) for n in sizes), cg_params=cg_params,
        drec_list=drec_list, gal_list=None, **kw)
    h1 = jfs.fictdom_h1_error_chunked(
        fine.mesh, jax.jit(jcell_geometry)(fine.mesh), fine.batch,
        fine.cell_loc, hdi, local, problem.sol_grad)
    return local, int(iters), int(exit_reason), float(rel), float(h1)
