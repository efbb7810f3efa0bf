"""Where the interface problem's preconditioner apply spends device time,
by CUDA events: the whole apply, the V-cycle (its graph's replay), the
copy maps P / P^T around it, the cut-band Schwarz term, and beside them
the doubled face operator, at N^2 k=1 on one circle of the benchmark's
``interface_circles_pool3`` pool. Each piece is run ``--warm`` times, then
timed over ``--reps`` calls; one JSON line per run on standard output.
With ``--profile K`` the line also gives, from torch.profiler over K
pairs of (operator, preconditioner) applies, the device seconds of each
kernel name, largest first.

The pieces are read from the apply's closure
(``interface_problem._interface_mg_precond``): the copy maps as gathers
(``g0``, ``cut_pos``, ``cut_dof``, ``inv``), or, where the closure holds
the scatter maps ``iH0`` ... ``iV1`` instead, as those scatters onto a
sentinel slot.

Usage (on the card):
    python scripts/interface_precond_split.py --N 1024 --circle 0
"""

import argparse
import inspect
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from benchmark.traffic import generate
from proton_tpu_torch.core.mesh import make_poly_mesh
from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import interface_problem as ip
from proton_tpu_torch.cut.classify import cut_preprocess
from proton_tpu_torch.cut.fictdom_structured import default_problem
from proton_tpu_torch.methods.cells_last import GridVecCL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ms_per_call(fn, warm: int, reps: int) -> float:
    for _ in range(warm):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def copy_maps(v, r, z):
    """P^T r and P z as the apply does them, without the V-cycle."""
    n = r.shape[0]
    if "inv" in v:
        def fn():
            r_ext = torch.cat([r, r.new_zeros(1)])
            r_ext.index_select(0, v["g0"]).index_add_(
                0, v["cut_pos"], r.index_select(0, v["cut_dof"]))
            torch.cat([z.H.reshape(-1), z.V.reshape(-1),
                       r.new_zeros(1)]).index_select(0, v["inv"])
        return fn

    iH0, iH1, iV0, iV1 = v["iH0"], v["iH1"], v["iV0"], v["iV1"]

    def fn():
        r_ext = torch.cat([r, r.new_zeros(1)])
        (r_ext[iH0] + r_ext[iH1]).permute(2, 0, 1).contiguous()
        (r_ext[iV0] + r_ext[iV1]).permute(2, 0, 1).contiguous()
        out = r.new_zeros(n + 1)
        for i0, i1, zg in ((iH0, iH1, z.H), (iV0, iV1, z.V)):
            zl = zg.permute(1, 2, 0).reshape(-1)
            out.index_add_(0, i0.reshape(-1), zl)
            out.index_add_(0, i1.reshape(-1), zl)
    return fn


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--N", type=int, default=1024)
    ap.add_argument("--circle", type=int, default=0,
                    help="which circle of the pool (0, 1 or 2)")
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--label", default="")
    ap.add_argument("--profile", type=int, default=0)
    args = ap.parse_args()

    with open(os.path.join(ROOT, "benchmark", "traffic",
                           "interface_circles_pool3.json")) as f:
        law = json.load(f)
    circle = generate.pool(law, {"N": args.N})[args.circle]
    p = default_problem(circle["radius"], tuple(circle["center"]))
    hdi, parms = HHODegreeInfo(2, 1), ip.InterfaceParams()
    mesh, cd = cut_preprocess(make_poly_mesh(Nx=args.N, Ny=args.N,
                                             device="cuda"), p.ls, levels=4)
    asm = ip.assemble_interface(mesh, cd, p.ls, hdi, p.rhs_fun, p.sol_fun,
                                parms)
    fsys = ip.condensed_face_system(mesh, asm, hdi, parms)
    M = fsys.precond
    v = inspect.getclosurevars(M).nonlocals
    mg, w_loc, Binv, gidx_p = v["mg"], v["w_loc"], v["Binv"], v["gidx_p"]
    n = fsys.rhs.shape[0]
    r = torch.randn(n, generator=torch.Generator("cuda").manual_seed(20),
                    device="cuda", dtype=fsys.rhs.dtype)
    x = GridVecCL(torch.randn_like(mg.graph.x.H),
                  torch.randn_like(mg.graph.x.V))
    z = mg.precondition(x)
    r_ext = torch.cat([r, r.new_zeros(1)])
    out = r.new_zeros(n + 1)

    def band():
        rl = w_loc * r_ext[gidx_p]
        zl = torch.bmm(Binv, rl[..., None])[..., 0]
        out.index_add_(0, gidx_p.reshape(-1), (w_loc * zl).reshape(-1))

    w, k = args.warm, args.reps
    ms = {"precond": ms_per_call(lambda: M(r), w, k),
          "vcycle_replay": ms_per_call(lambda: mg.precondition(x), w, k),
          "copy_maps": ms_per_call(copy_maps(v, r, z), w, k),
          "band": ms_per_call(band, w, k),
          "face_operator": ms_per_call(lambda: fsys.apply(r), w, k)}
    kernels = []
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.profile):
                M(fsys.apply(r))
            torch.cuda.synchronize()
        kernels = sorted(((e.key[:100], e.self_device_time_total / 1e6)
                          for e in prof.key_averages()
                          if e.self_device_time_total > 0),
                         key=lambda kv: -kv[1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "label": args.label, "N": args.N, "circle": circle,
        "face_dofs": n, "cut_cells": len(asm.dm.cut_ids),
        "copy_form": "gather" if "inv" in v else "sentinel_scatter",
        "map_bytes": sum(int(v[m].numel() * v[m].element_size()) for m in
                         ("g0", "cut_pos", "cut_dof", "inv", "iH0", "iH1",
                          "iV0", "iV1") if m in v),
        "ms": ms, "profiled_pairs": args.profile, "kernels_s": kernels,
        "card": card.strip(), "torch": torch.__version__}))


if __name__ == "__main__":
    main()
