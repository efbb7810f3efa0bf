#!/usr/bin/env python3
"""Chip smoke test of proton_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order, each printing its numbers on lines of its own:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: K1 (csrc/fused_assembly.cu) with nvcc for sm_90a, with the
   registers, stack and spills ptxas reports for every instantiation,
   its dynamic shared memory and its resident blocks per SM;
3. kernels: K1 against its plain PyTorch version on the 1024^2 flagship
   mesh, float64 at k=0, 1, 2 and at (cell, face) degrees (1, 1)
   (max|diff|/max|plain| < 1e-11) and float32 at k=1 (< 1e-4), with the
   kernel's time (CUDA events), the plain version's time, the bound on
   this card, the share of the bound reached and the bytes per second;
4. main path: solve_fictdom_structured(1024, 1, fitted="full",
   precond="block_jacobi") in float64 at CG tol 1e-11, with K1's launch
   count read around it; then the assembly phase at the same size split
   into its parts, and torch.profiler over 60 CG iterations of the same
   system (device time by op, device busy share);
5. checks: the H1 order between 512^2 and 1024^2, and the 32^2 k=1 gate
   of the JAX package on the CPU;
6. k=2: the 256^2 solve (the d=22 instantiation on the solve path), with
   K1's launch count read around it.

Any failed check raises, so the script exits non-zero and prints no
result. Without a CUDA device it exits non-zero before any phase. The
second-to-last line is the kernels' JSON record (K1 at k=1 with its
main-path launches, and at k=2 with the 256^2 solve's), the last line
{"ok": true, "device": {...}}.
"""

import json
import math
import re
import subprocess
import sys
import time

import torch

# (iterations, H1) of the JAX package on the CPU in float64 at 32^2 k=1,
# solve_fictdom_structured(32, 1, precond="block_jacobi", fitted="full",
# mixed=False, use_pallas=False), CG tol 1e-10, divergence 1e8,
# max_iter 50000 (the port's CPU gate, tests/test_torch_solve.py).
GATE_32 = (115, 1.1344765273981145e-3)

# Peak rates (NVIDIA data sheets, dense, at the full power limit):
# memory bytes/s, float64 and float32 FLOP/s outside the tensor cores.
PEAKS = (("H100 PCIe", 2.0e12, 25.6e12, 51.2e12),
         ("H100 NVL", 3.9e12, 30.0e12, 60.0e12),
         ("H200", 4.8e12, 34.0e12, 67.0e12),
         ("H100", 3.35e12, 34.0e12, 67.0e12))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def line(tag: str, **kv) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def peaks(name: str):
    for key, bw, f64, f32 in PEAKS:
        if key in name:
            return key, bw, f64, f32
    raise RuntimeError(f"no peak rates known for {name!r}")


def k1_flops_per_cell(cd: int, fd: int) -> int:
    """Floating-point operations of K1 for one cell (counted from the
    algorithm: cell quadrature, face quadrature, stabilization solves,
    reconstruction solve, the d x d product)."""
    rec = fd + 1
    rbs = (rec + 1) * (rec + 2) // 2
    cbs = (cd + 1) * (cd + 2) // 2
    fbs = fd + 1
    d, nr = cbs + 4 * fbs, rbs - 1
    cell_q = (rec + 1) ** 2 * (40 + 6 * rbs + 2 * nr * (nr + 1))
    face_q = 4 * (fd + 1) * (30 + 9 * rbs + 2 * nr * (fbs + cbs) +
                             fbs * (fbs + 1) + 2 * fbs * cbs)
    stab = 4 * (fbs ** 3 // 3 + 2 * fbs * fbs * cbs + 2 * fbs * cbs * cbs)
    recon = nr ** 3 // 3 + nr * nr * d + 2 * nr * d * d
    return cell_q + face_q + stab + recon + 2 * d * d


def cuda_ms(fn, reps: int) -> float:
    """Mean time of fn() on the card over reps calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_summary(log: str):
    """(dtype, cell degree, face degree) -> (registers, stack, spill
    stores, spill loads) from nvcc -Xptxas -v output."""
    out, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"fused_assembly_kernelI([df])Li(\d)ELi(\d)E", ln)
        if m and "Compiling entry" in ln:
            key = ("f64" if m.group(1) == "d" else "f32", int(m.group(2)),
                   int(m.group(3)))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and key:
            out[key] = [None, *map(int, m.groups())]
        m = re.search(r"Used (\d+) registers", ln)
        if m and key in out:
            out[key][0] = int(m.group(1))
    return out


def assembly_split(N: int, k: int, device: str = "cuda") -> None:
    """The assembly phase of the N^2 level split into its parts, called in
    turn as cut/fictdom_structured.py:_assemble_level_cl runs them, with a
    device synchronize after each (host clock)."""
    from proton_tpu_torch.config import synchronize
    from proton_tpu_torch.core.geometry import cell_geometry
    from proton_tpu_torch.core.ops import HHODegreeInfo, cell_rhs
    from proton_tpu_torch.cut import fictdom_structured as fs
    from proton_tpu_torch.cut import methods as cut_methods
    from proton_tpu_torch.cut.classify import LOC_NEG
    from proton_tpu_torch.methods import cells_last
    from proton_tpu_torch.methods import fused_assembly as fa

    device = torch.device(device)
    hdi, problem, eta = HHODegreeInfo(k + 1, k), fs.default_problem(), \
        fs.nitsche_eta(k)
    mesh, _, _, cell_loc, batch, _ = fs._classify(N, problem, 4,
                                                  device=device)
    synchronize(device)
    parts = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        synchronize(device)
        parts[name] = time.perf_counter() - t0
        return out

    def cut_operators():
        _, data = cut_methods.cut_hho_laplacian(batch, problem.ls, hdi,
                                                LOC_NEG, eta=eta)
        return data + cut_methods.cut_stabilization(batch, hdi, LOC_NEG)

    def rhs():
        f_std = cell_rhs(mesh, geom, hdi.cell_degree, problem.rhs_fun)
        f = torch.where((cell_loc == LOC_NEG)[:, None], f_std,
                        torch.zeros_like(f_std))
        f[batch.ids] = cut_methods.cut_rhs(batch, hdi.cell_degree,
                                           problem.rhs_fun, problem.ls,
                                           problem.sol_fun, LOC_NEG, eta=eta)
        return f.T

    geom = timed("cell_geometry_s", lambda: cell_geometry(mesh))
    inputs = timed("pack_inputs_s", lambda: fa.pack_inputs(mesh, geom))
    lc = timed("k1_s", lambda: fa.fused_local_operator(
        *inputs, hdi.cell_degree, hdi.face_degree))
    lc_cut = timed("cut_operators_s", cut_operators)
    d = lc_cut.shape[1]
    timed("set_columns_s", lambda: cells_last.set_columns(
        lc, batch.ids, lc_cut.permute(1, 2, 0).reshape(d * d, -1)))
    timed("rhs_s", rhs)
    line("assembly", N=N, k=k, cut_cells=len(batch.ids),
         total_s=sum(parts.values()), **parts)
    return lc


def profile_cg(N: int, k: int, iterations: int) -> None:
    """torch.profiler over `iterations` block-Jacobi CG iterations of the
    N^2 system: the device time of the operator apply, the preconditioner
    and the rest of the CG loop (dots, axpys), the top ops by device time,
    and the device's busy share of the window (profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from proton_tpu_torch.core.ops import HHODegreeInfo
    from proton_tpu_torch.cut import fictdom_structured as fs
    from proton_tpu_torch.solvers import cg

    hdi, problem = HHODegreeInfo(k + 1, k), fs.default_problem()
    level = fs.build_level(N, hdi, problem, fs.nitsche_eta(k), 4,
                           device="cuda")
    fsys = fs.face_system(level, N, hdi, problem, "block_jacobi",
                          device="cuda")

    def labelled(name, fn):
        def call(x):
            with record_function(name):
                return fn(x)
        return call

    apply_S = labelled("apply_S", fsys.apply_S)
    precond = labelled("block_jacobi", fsys.precond)

    def run(n):
        # tol 0 never converges: exactly n iterations, exit 2
        return cg.conjugated_gradient(apply_S, fsys.rhs, None,
                                      cg.CGParams(0.0, 1e8, n - 2, True),
                                      precond=precond)

    run(4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run(iterations)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(res.iterations == iterations, "profile window length")
    events = prof.key_averages()
    labels = ("apply_S", "block_jacobi")
    # kernels only: the labels also appear as device-side spans
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA
                    and e.key not in labels)
    if device_us == 0:
        line("profile", N=N, k=k, device_time="not measured")
        return
    per_it = lambda us: us / iterations
    region = {e.key: e.device_time_total for e in events
              if e.device_type == DeviceType.CPU
              and e.key in labels}
    rest = device_us - sum(region.values())
    line("profile", N=N, k=k, iterations=iterations,
         ms_per_iteration=1e3 * wall / iterations,
         device_us_per_iteration=per_it(device_us),
         apply_S_us=per_it(region.get("apply_S", 0.0)),
         block_jacobi_us=per_it(region.get("block_jacobi", 0.0)),
         other_cg_us=per_it(rest),
         device_busy_share=device_us / 1e6 / wall)
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.key.startswith("aten::") and e.self_device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:8]:
        line("profile_op", op=e.key, calls_per_iteration=e.count / iterations,
             device_us_per_iteration=per_it(e.self_device_time_total),
             share=e.self_device_time_total / device_us)
    del level, fsys
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from proton_tpu_torch import native
    from proton_tpu_torch.core.geometry import cell_geometry
    from proton_tpu_torch.core.mesh import make_poly_mesh
    from proton_tpu_torch.cut import fictdom_structured as fs
    from proton_tpu_torch.methods import fused_assembly as fa
    from proton_tpu_torch.solvers import cg

    t_start = time.perf_counter()
    # 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    peak_key, bw, f64_peak, f32_peak = peaks(name)
    line("device", name=repr(name), count=count, torch=torch.__version__,
         cuda=torch.version.cuda, peaks=peak_key)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    build = native.build("fused_assembly")["fused_assembly"]
    line("build", source="proton_tpu_torch/csrc/fused_assembly.cu",
         seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=round(build.seconds, 3))
    ptxas = ptxas_summary(build.log)
    for (dtype, cd, fd), (tile, warps, smem) in fa.LAUNCH_GEOMETRY.items():
        dt = "f64" if dtype == torch.float64 else "f32"
        check((dt, cd, fd) in ptxas,
              f"ptxas reported nothing for the instantiation {dt}<{cd},{fd}>")
        reg, stack, st, ld = ptxas[(dt, cd, fd)]
        line("ptxas", kernel=f"{dt}<{cd},{fd}>", registers=reg,
             stack_bytes=stack, spill_stores=st, spill_loads=ld,
             tile_cells=tile, warps=warps, dynamic_smem_bytes=smem,
             blocks_per_sm=fa.blocks_per_sm(cd, fd, dtype))

    # 3. kernels against their plain version at the flagship mesh
    mesh = make_poly_mesh(Nx=1024, Ny=1024, device="cuda")
    inputs = fa.pack_inputs(mesh, cell_geometry(mesh))
    C = mesh.num_cells
    del mesh
    rows = {}
    for cd, fd, dtype, tol in ((1, 0, torch.float64, 1e-11),
                               (2, 1, torch.float64, 1e-11),
                               (3, 2, torch.float64, 1e-11),
                               (1, 1, torch.float64, 1e-11),
                               (2, 1, torch.float32, 1e-4)):
        k = fd
        x = tuple(a.to(dtype) for a in inputs)
        out = fa.fused_local_operator(*x, cd, fd)
        torch.cuda.synchronize()
        ref = fa.fitted_local_operator_plain(*x, cd, fd)
        max_abs = float((out - ref).abs().max())
        rel = max_abs / float(ref.abs().max())
        del out, ref
        ms = cuda_ms(lambda: fa.fused_local_operator(*x, cd, fd), 20)
        plain_ms = cuda_ms(lambda: fa.fitted_local_operator_plain(*x, cd, fd),
                           3)
        d = (cd + 1) * (cd + 2) // 2 + 4 * (fd + 1)
        item = torch.finfo(dtype).bits // 8
        nbytes = (40 + d * d) * item * C
        bytes_ms = nbytes / bw * 1e3
        flop_ms = k1_flops_per_cell(cd, fd) * C / (
            f64_peak if dtype == torch.float64 else f32_peak) * 1e3
        bound_ms = max(bytes_ms, flop_ms)
        bound_by = "bytes" if bytes_ms >= flop_ms else "operations"
        line("kernel", name="fused_local_operator", k=k, cell_degree=cd,
             face_degree=fd, dtype=str(dtype).split(".")[1], cells=C,
             max_rel_err=rel, max_abs_err=max_abs, tol=tol, ms=ms,
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
             bytes_ms=bytes_ms, flop_ms=flop_ms, bound_share=bound_ms / ms,
             gb_per_s=nbytes / ms / 1e6)
        check(rel < tol, f"K1 <{cd},{fd}> {dtype}: rel err {rel} >= {tol}")
        rows[(cd, fd, dtype)] = dict(max_abs_err=max_abs, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_by=bound_by)
        del x
    del inputs
    torch.cuda.empty_cache()

    def solve(N, k, tol):
        params = cg.CGParams(convergence_threshold=tol,
                             divergence_threshold=1e8, max_iter=50000,
                             apply_preconditioner=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = fs.solve_fictdom_structured(N, k, fitted="full",
                                        precond="block_jacobi",
                                        cg_params=params, device="cuda",
                                        dtype=torch.float64)
        wall = time.perf_counter() - t0
        d = (k + 2) * (k + 3) // 2 + 4 * (k + 1)
        line("solve", N=N, k=k, tol=tol, exit=r.exit_reason,
             iterations=r.iterations, rel=r.rel_residual, h1=r.h1_error,
             ms_per_iteration=1e3 * r.timings["cg_s"] / max(r.iterations, 1),
             wall_s=wall, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
             **{key: round(v, 4) for key, v in r.timings.items()})
        check(r.exit_reason == cg.CONVERGED and r.rel_residual < tol,
              f"{N}^2 k={k}: exit {r.exit_reason}, rel {r.rel_residual}")
        check(tuple(r.local.shape) == (N * N, d) and
              bool(torch.isfinite(r.local).all()), f"{N}^2 k={k}: local")
        check(math.isfinite(r.h1_error), f"{N}^2 k={k}: H1 {r.h1_error}")
        return r

    # 4. main path: launch counts read around it
    fa.fused_local_operator.launches = 0
    r1024 = solve(1024, 1, 1e-11)
    launches = fa.fused_local_operator.launches
    line("main_path", kernel="fused_local_operator", launches=launches)
    check(launches > 0, "the 1024^2 solve did not launch K1")

    # 4b. the assembly phase at the main path's shape, split into its parts
    assembly_split(1024, 1)
    torch.cuda.empty_cache()

    # 4c. where a CG iteration's time goes at the main path's shape
    profile_cg(1024, 1, iterations=60)

    # 5. checks: H1 order 512 -> 1024, and the JAX CPU gate at 32^2
    r512 = solve(512, 1, 1e-11)
    order = math.log2(r512.h1_error / r1024.h1_error)
    line("order", h1_512=r512.h1_error, h1_1024=r1024.h1_error, order=order)
    check(1.8 <= order <= 2.2, f"H1 order {order} outside [1.8, 2.2]")
    r32 = solve(32, 1, 1e-10)
    line("gate32", iterations=r32.iterations, ref_iterations=GATE_32[0],
         h1=r32.h1_error, ref_h1=GATE_32[1])
    check(abs(r32.iterations - GATE_32[0]) <= 2, "32^2 iterations")
    check(math.isclose(r32.h1_error, GATE_32[1], rel_tol=1e-6), "32^2 H1")

    # 6. k=2 on the solve path, with its own launch count
    fa.fused_local_operator.launches = 0
    solve(256, 2, 1e-10)
    launches_k2 = fa.fused_local_operator.launches
    line("k2_path", kernel="fused_local_operator", launches=launches_k2)
    check(launches_k2 > 0, "the 256^2 k=2 solve did not launch K1")

    line("total", seconds=round(time.perf_counter() - t_start, 3))
    print(smi, flush=True)
    record = dict(route="cuda", source="proton_tpu_torch/csrc/fused_assembly.cu",
                  replaces="proton_tpu/methods/pallas_assembly.py:315",
                  library_ms=None)
    print(json.dumps({"kernels": [
        dict(name="fused_local_operator", launches=launches, **record,
             **rows[(2, 1, torch.float64)]),
        dict(name="fused_local_operator_k2", launches=launches_k2, **record,
             **rows[(3, 2, torch.float64)])]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
