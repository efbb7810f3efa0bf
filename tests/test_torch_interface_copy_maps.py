"""The copy maps P / P^T of the interface problem's MG preconditioner
(``interface_problem._interface_mg_precond``) at 16^2 k=1 on an offset
circle with cut faces, float64 on the CPU, against a frozen copy of their
sentinel form: P^T as two gathers per grid, one of which reads a zero for
every face without a second copy, and P as four ``index_add_`` scatters
that send every entry without a condensed dof to one sentinel slot. The
apply equals the sentinel form's to 1e-15 relative and is symmetric; P's
map names no sentinel slot and fills every condensed dof exactly once."""

import inspect

import numpy as np
import pytest
import threadpoolctl
import torch

from proton_tpu_torch.core.mesh import BND_DIRICHLET, make_poly_mesh
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import interface_problem as ip
from proton_tpu_torch.cut.classify import cut_preprocess
from proton_tpu_torch.cut.fictdom_structured import default_problem
from proton_tpu_torch.cut.methods import InterfaceParams
from proton_tpu_torch.methods.cells_last import GridVecCL
from proton_tpu_torch.utils.timing import sink

CPU = torch.device("cpu")
N = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """BLAS and torch on one thread (ROADMAP's rule for solving tests)."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    """The preconditioner's arguments as ``condensed_face_system`` passes
    them, for a circle off the mesh's centre."""
    p = default_problem(0.35, (0.5 + 0.3 / N, 0.5 - 0.2 / N))
    mesh, cd = cut_preprocess(make_poly_mesh(Nx=N, Ny=N, device=CPU), p.ls,
                              levels=4)
    hdi, parms = HHODegreeInfo(2, 1), InterfaceParams()
    asm = ip.assemble_interface(mesh, cd, p.ls, hdi, p.rhs_fun, p.sol_fun,
                                parms)
    seen = []
    real = ip._interface_mg_precond
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ip, "_interface_mg_precond",
                   lambda *a: seen.append(a) or real(*a))
        assert ip.condensed_face_system(mesh, asm, hdi,
                                        parms).preconditioner == "mg"
    return seen[0]


def sentinel_maps(mesh, dm, sent):
    """The sentinel form's index maps iH0, iH1 [N+1, N, fbs] and iV0, iV1
    [N, N+1, fbs]: copy c of each grid face's dofs, ``sent`` where the
    face is Dirichlet or (c = 1) has no second copy."""
    fbs = dm.fbs
    cf = mesh.cell_faces.numpy()
    cells = np.arange(N * N).reshape(N, N)
    fH = np.empty((N + 1, N), np.int64)
    fH[:N] = cf[cells, 0]
    fH[N] = cf[cells[N - 1], 2]
    fV = np.empty((N, N + 1), np.int64)
    fV[:, :N] = cf[cells, 3]
    fV[:, N] = cf[cells[:, N - 1], 1]
    face_start = dm.face_table.numpy() * fbs
    is_cut = dm.face_is_cut.numpy()
    is_dir = mesh.face_bnd.numpy() == BND_DIRICHLET

    def copy_idx(fgrid, cp):
        base = face_start[fgrid] + cp * fbs
        dead = is_dir[fgrid] if cp == 0 else \
            (is_dir[fgrid] | ~is_cut[fgrid])
        idx = base[..., None] + np.arange(fbs)
        return torch.as_tensor(np.where(dead[..., None], sent, idx))

    return (copy_idx(fH, 0), copy_idx(fH, 1), copy_idx(fV, 0),
            copy_idx(fV, 1))


def sentinel_apply(M, maps, sent):
    """M's apply with P / P^T in the sentinel form, around the same
    V-cycle and cut-band Schwarz term (read from M's closure)."""
    v = inspect.getclosurevars(M).nonlocals
    mg, w_loc, Binv, gidx_p = v["mg"], v["w_loc"], v["Binv"], v["gidx_p"]
    iH0, iH1, iV0, iV1 = maps

    def apply(r):
        r_ext = torch.cat([r, r.new_zeros(1)])
        H = (r_ext[iH0] + r_ext[iH1]).permute(2, 0, 1).contiguous()
        V = (r_ext[iV0] + r_ext[iV1]).permute(2, 0, 1).contiguous()
        z = mg.precondition(GridVecCL(H, V))
        out = r.new_zeros(sent + 1)
        for i0, i1, zg in ((iH0, iH1, z.H), (iV0, iV1, z.V)):
            zl = zg.permute(1, 2, 0).reshape(-1)
            out.index_add_(0, i0.reshape(-1), zl)
            out.index_add_(0, i1.reshape(-1), zl)
        rl = w_loc * r_ext[gidx_p]
        zl = torch.bmm(Binv, rl[..., None])[..., 0]
        out.index_add_(0, gidx_p.reshape(-1), (w_loc * zl).reshape(-1))
        return out[:sent]

    return apply


def test_apply_equals_the_sentinel_form_and_is_symmetric(inputs):
    mesh, dm, sent = inputs[:3]
    assert bool(dm.face_is_cut.any())
    M = ip._interface_mg_precond(*inputs)
    old = sentinel_apply(M, sentinel_maps(mesh, dm, sent), sent)
    rng = np.random.default_rng(20)
    rs = [torch.as_tensor(rng.standard_normal(sent)) for _ in range(3)]
    for r in rs:
        z, want = M(r), old(r)
        assert float((z - want).abs().max()) <= \
            1e-15 * float(want.abs().max())
    a = float(torch.dot(rs[1], M(rs[0])))
    b = float(torch.dot(rs[0], M(rs[1])))
    assert abs(a - b) < 1e-12 * abs(a)


def test_p_fills_each_dof_once_from_its_grid_entry(inputs):
    """P's map names no sentinel slot, and every condensed dof reads the
    grid entry that the sentinel form scatters to it, the only entry
    that names it there: copy 0 of each face onto distinct entries, the
    cut faces' second copies onto their first copy's entry."""
    mesh, dm, sent = inputs[:3]
    fbs = dm.fbs
    t = {}
    with sink(t):
        M = ip._interface_mg_precond(*inputs)
    assert t["iface_copy_sentinel_writes"] == 0
    inv = inspect.getclosurevars(M).nonlocals["inv"].numpy()
    G = 2 * fbs * N * (N + 1)
    assert inv.shape == (sent + 1,) and inv[sent] == G
    assert (inv[:sent] >= 0).all() and (inv[:sent] < G).all()

    # grid position of each entry of the sentinel maps, in the V-cycle's
    # [fbs, N+1, N] / [fbs, N, N+1] layout, flattened H then V
    nH = fbs * (N + 1) * N
    posH = np.arange(nH).reshape(fbs, N + 1, N).transpose(1, 2, 0)
    posV = nH + np.arange(nH).reshape(fbs, N, N + 1).transpose(1, 2, 0)
    iH0, iH1, iV0, iV1 = (m.numpy() for m in sentinel_maps(mesh, dm, sent))
    dofs = np.concatenate([m.reshape(-1) for m in (iH0, iH1, iV0, iV1)])
    pos = np.concatenate([p.reshape(-1) for p in (posH, posH, posV, posV)])
    live = dofs < sent
    # the sentinel form writes ~G/2 of its 2G entries to the sentinel
    assert np.count_nonzero(~live) > G // 2
    np.testing.assert_array_equal(np.sort(dofs[live]), np.arange(sent))
    np.testing.assert_array_equal(inv[dofs[live]], pos[live])
    second = np.concatenate([iH1.reshape(-1), iV1.reshape(-1)])
    second = second[second < sent]
    assert len(second) > 0
    np.testing.assert_array_equal(inv[second], inv[second - fbs])
    assert len(np.unique(inv[:sent])) == sent - len(second)
