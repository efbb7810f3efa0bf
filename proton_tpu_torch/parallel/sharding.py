"""Cell-sharded solve on torch.distributed (JAX counterpart:
proton_tpu/parallel/sharding.py).

Per-element assembly couples no two cells; only the Krylov solve reduces
globally. Each rank holds a contiguous slab of the cell arrays (the local
matrices lc and their dofmap rows) and the whole global vector,
replicated. An operator apply is the rank's gather / batched product /
scatter into a full-length vector, completed by one all_reduce(SUM); the
Jacobi diagonal likewise. CG's dot products then run on the replicated
vector, so every rank takes the same steps. The JAX package gets the
same from sharding annotations (XLA inserts the reduction); here the
collective is explicit.

The default process group carries CUDA tensors over NCCL and CPU tensors
over gloo. ``make_device_mesh`` starts it (or takes the one already
started) and raises when the device's backend cannot run: no quiet
switch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..config import resolve_device
from ..core.ops import HHODegreeInfo
from ..methods import assembly
from ..solvers import cg


class DeviceMesh(NamedTuple):
    """The ranks of the default process group and this rank's device."""

    rank: int
    world_size: int
    device: torch.device
    backend: str


def make_device_mesh(device=None, *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> DeviceMesh:
    """The default process group's ranks and this rank's device.

    ``device``: CUDA unless ``"cpu"`` (config.resolve_device). The backend
    follows the device: NCCL for CUDA tensors, gloo for CPU tensors; it
    raises when that backend cannot run here (no CUDA device for NCCL, or
    a torch build without it). Without a started default group,
    ``init_method`` (e.g. ``file:///tmp/pg`` or
    ``tcp://localhost:29500``), ``rank`` and ``world_size`` start it. On
    CUDA each rank takes card rank % device_count unless ``device`` names
    one."""
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    available = dist.is_available() and (
        dist.is_nccl_available() and torch.cuda.is_available()
        if backend == "nccl" else dist.is_gloo_available())
    if not available:
        raise RuntimeError(f"torch.distributed backend {backend!r} for "
                           f"device {device} is not available here")
    if not dist.is_initialized():
        if init_method is None or rank is None or world_size is None:
            raise ValueError("no process group is started: pass "
                             "init_method, rank and world_size")
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()!r}, "
                           f"not {backend!r}")
    rank, world = dist.get_rank(), dist.get_world_size()
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return DeviceMesh(rank, world, device, backend)


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(fn(a) for a in tree))


def _slab(dmesh: DeviceMesh, n: int) -> slice:
    """This rank's contiguous share of n rows (n a multiple of the world
    size)."""
    if n % dmesh.world_size:
        raise ValueError(f"{n} rows do not split over {dmesh.world_size} "
                         "ranks: pad them first (pad_cells_to_multiple, "
                         "build_dofmap_padded)")
    nb = n // dmesh.world_size
    return slice(dmesh.rank * nb, (dmesh.rank + 1) * nb)


def shard_cells(dmesh: DeviceMesh, tree):
    """This rank's slab of every tensor of ``tree`` (a tensor or a tuple
    of them) along its leading (cell) axis, on the rank's device; 0-d
    tensors whole."""
    def take(a):
        a = a if a.ndim == 0 else a[_slab(dmesh, a.shape[0])]
        return a.to(dmesh.device)
    return _map(take, tree)


def replicate(dmesh: DeviceMesh, tree):
    """Every tensor of ``tree`` on the rank's device, equal on all ranks:
    rank 0's copy is broadcast."""
    def put(a):
        a = a.to(dmesh.device).contiguous()
        if dmesh.world_size > 1:
            a = a.clone()
            dist.broadcast(a, src=0)
        return a
    return _map(put, tree)


def pad_cells_to_multiple(mesh, n: int):
    """(mesh', C): the mesh with its cell count padded to a multiple of n
    by repeating the last cell (its rows in build_dofmap_padded are
    sentinel, so the copies change nothing)."""
    C = mesh.cell_ptids.shape[0]
    rem = (-C) % n
    if rem == 0:
        return mesh, C

    def pad(a):
        return torch.cat([a, a[-1:].expand(rem, *a.shape[1:])])

    return dataclasses.replace(mesh, cell_ptids=pad(mesh.cell_ptids),
                               cell_npts=pad(mesh.cell_npts),
                               cell_faces=pad(mesh.cell_faces)), C


def build_dofmap_padded(mesh, hdi: HHODegreeInfo, n_devices: int):
    """(DofMap, C): the dofmap of ``mesh`` with its cell count padded to a
    multiple of n_devices. The padded cells' rows are all sentinel: they
    read zeros and scatter into the dropped bin."""
    dm = assembly.build_dofmap(mesh, hdi)
    C, d = dm.asm_idx.shape
    rem = (-C) % n_devices
    if rem == 0:
        return dm, C

    def pad(a, value):
        return torch.cat([a, a.new_full((rem, d), value)])

    return dataclasses.replace(
        dm, asm_idx=pad(dm.asm_idx, dm.n_dofs),
        free_local=pad(dm.free_local, False),
        dirichlet_local=pad(dm.dirichlet_local, False),
        n_cells=C + rem), C


def sharded_solve(dmesh: DeviceMesh, dofmap: assembly.DofMap, lc, rhs,
                  cg_params: cg.CGParams) -> cg.CGResult:
    """Jacobi PCG on the global system of lc [C, d, d] (C padded to a
    multiple of the world size, build_dofmap_padded) with the cells
    sharded and the vector replicated. Every rank passes the whole lc and
    rhs and gets the whole solution."""
    lc = shard_cells(dmesh, lc)
    idx = shard_cells(dmesh, dofmap.asm_idx)
    rhs = replicate(dmesh, rhs)
    n = dofmap.n_dofs

    def all_sum(y):
        dist.all_reduce(y)
        return y

    def apply_A(x):
        y_loc = torch.bmm(lc, assembly.gather_values(idx, x)[..., None])
        return all_sum(assembly.scatter_values(idx, n, y_loc[..., 0]))

    diag = all_sum(assembly.scatter_values(
        idx, n, torch.diagonal(lc, dim1=1, dim2=2)))
    return cg.conjugated_gradient(apply_A, rhs, diag, cg_params)
