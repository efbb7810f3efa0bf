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
   K1's launch count read around it;
7. the default path, solve_fictdom_structured(1024, 1) = fitted="lean",
   precond="mg", at CG tol 1e-11, with K1's launch count and the cell
   counts of its launches read around it. Its solution is held against
   phase 4's (the fully assembled system: local dofs within 2e-7, H1
   within 1%, the gap being the full assembly's rounding times the
   condition number) and against the same lean system solved with
   block-Jacobi (local dofs within 2e-8, H1 within 2e-3). Then K1 against
   its plain version at every shape the lean and the multigrid paths give
   it, on each level 1024^2 ... 8^2: one cell of that level's size and the
   level's displaced cells, at k=1 and k=2, and every cell of the
   classified mesh at k=1 (at 256^2 also k=2, phase 6's shape). The cell
   counts K1 was launched at in the lean solves must be the ones compared;
8. fitted="full" with precond="mg" at 512^2 (K1 on every cell of every
   level) against the lean solve at 512^2; the 32^2 and 64^2 gates of the
   JAX package's lean + multigrid solve on the CPU;
9. k=2 with the default path: the 64^2 and 128^2 gates of the JAX
   package, then 256^2 and 1024^2 (tol 1e-11) with the H1 orders
   between them;
10. torch.profiler over 10 multigrid-PCG iterations at 1024^2 k=1: device
    time by region (operator, Chebyshev, patch, restrict, prolong, coarse
    solve, the rest) and by level, kernel launches per iteration, the
    device's busy share, and the scalar reads and host-to-device copies
    per iteration (one read, the CG exit test, and no copy);

the uncut HHO path (methods/hho.py, assembly.py, condensation.py,
poisson.py, obstacle.py; no kernel of its own):

11. [hho] on the 1024^2 quad mesh at k=1 and k=2: hho_laplacian +
    naive_stabilization against K1 on the same mesh (max|diff| / max|K1|
    < 1e-11), and the time and peak memory of hho_laplacian +
    fancy_stabilization;
12. [convergence] the BASELINE configuration, convergence_test's study at
    k=0..3, N=16..256, Jacobi PCG at tol 1e-12: N=16 and 32 equal to the
    JAX package's CPU numbers (errors rtol 1e-6, iterations within 2), the
    orders from 64^2 to 128^2 (L2 k+2, energy k+1, +-0.2);
13. [poisson_1024] 1024^2 k=1 with solve_poisson (full system) and with
    solve_condensed (gather form), tol 1e-12: the two local solutions
    agree, L2 and energy orders from 512^2 near 3 and 2, iterations, ms
    per iteration, time by phase and peak memory;
14. [obstacle] run_obstacle(N, k), N = 8 ... 128, k = 0, 1: all ten energy
    errors equal to the reference's stored table (rel 1e-4);
15. [polymesh] brick meshes (6-gons, with 4- and 5-gons at the boundary)
    of 16^2, 256^2 and 512^2 bricks loaded with load_poly_mesh and solved
    at HHODegreeInfo(k, k), k = 0, 1: the 16^2 mesh equal to the JAX
    package's CPU numbers, the L2 orders from 256^2 to 512^2;

the generic cut path (cut/classify.cut_preprocess, cut/fictdom.py,
cut/interface_problem.py, cut/agglomerate.py, apps/cuthho_square.py; no
kernel of its own):

16. [cut_preprocess] the generic classification of every cell of the
    1024^2 mesh against the band one (codes and moved points equal), the
    agglomeration-detection branch and make_neighbors_info at 1024^2;
17. [fictdom_generic] Jacobi PCG on the full system, tol 1e-12: the JAX
    package's CPU numbers at 16^2, 32^2 k=1 and 16^2 k=2, then 64^2,
    128^2, 256^2 k=1 (H1 order 128 -> 256 in [1.8, 2.2]) and, at 256^2,
    H1 within 1e-6 of the structured solve of the same problem;
18. [interface] condensed + uniform MG + cut-band Schwarz, tol 1e-9: the
    JAX gates at 16^2, 32^2 (k=0, 1) and 16^2 k=2, the full system
    against the condensed one at 16^2, kappa_2 = 3 on the block-Jacobi
    branch at 64^2, then 256^2 and 512^2 k=1 (H1 order 256 -> 512 in
    [1.8, 2.2]) and torch.profiler over 10 of its CG iterations at 512^2
    (one scalar read per iteration, no host-to-device copy);
19. [agglomerate] the merge at 128^2 and 256^2 (seconds by part), plain
    classification and the fictdom solve on the merged mesh: area 1 to
    1e-12, no badly cut cell left, H1 order above 1.6;
20. [cuthho_square] the app with -f -i at the BASELINE configuration
    (64^2, k=1) against the JAX app's errors, then -A -f -d at 16^2 in a
    temporary directory;

the geometry families (cut/batched.py, apps/fictdom_family.py; K1 on
every cell of each geometry's displaced mesh) and the structured-solve
options:

21. [family] K1 against its plain version on one geometry's displaced
    1024^2 mesh at k=1; the 1024^2 k=1 family of one circle at the app's
    tol 1e-6 (all converged, no overflow, no bad cut; K1 launched once per
    geometry on all 1,048,576 cells, the count read around the call;
    iterations, ms per iteration, seconds per geometry by phase, peak
    memory); the app at its documented widths (-N 256 -k 1) with 8 of
    the documented 64 geometries (-B 8);
    the ellipse and flower families at 256^2 B=2; two geometries at 128^2,
    tol 1e-10, each equal to the structured solve of the same circle (H1
    rtol 1e-8);
22. [options] k=1, tol 1e-11: fitted="uniform" equal to fitted="lean" at
    256^2, the damped block-Jacobi and Jacobi multigrid smoothers against
    the Chebyshev one at 64^2 (local dofs within 2e-8), and
    classify_level(method="full") equal to the band one at 1024^2;

the Galerkin coarse hierarchy (solvers/multigrid.py's pair-operator
engine, cut/fictdom_structured.band_galerkin_levels; K1 on the lean
path's shapes) and parallel/ (torch.distributed; no kernel of its own):

23. [galerkin] tol 1e-11: the JAX package's gates with mg_galerkin=True
    at 16^2, 32^2 k=1 (also mg_gamma=2) and 16^2 k=2 (iterations within
    2, H1 rtol 1e-6 at k=1, 1e-4 at k=2); k=2 at 256^2
    with iterations, ms per iteration, galerkin_setup_s, deviation pairs
    per level, peak memory and K1's launches, held against the
    rediscretized solve of the same N, k and tol, reused from phase 9
    (local dofs within 1e-6 of max|local|; H1 rtol 1e-4); torch.profiler
    over 20 Galerkin-MG
    iterations at 256^2 k=2 (`[profile_galerkin*]`: device time by
    region and level, the Galerkin apply's conv and pairs by level,
    launches, busy share, one scalar read and no host-to-device copy per
    iteration); k=1 at 1024^2 capped at 300 iterations, where it stalls
    (`[galerkin_stall]`: the residual must be below 3e-4; it is not held
    against phase 7's solution);
24. [parallel] one rank on NCCL (world size 1, file:// store in a
    temporary directory): sharded_solve and solve_condensed_halo at 512^2
    k=1 against the single-process solves (equal iterations, 1e-9),
    halo_diagonal against structured_diagonal. Exchanges between ranks
    are held only by the CPU tests (gloo, 2 and 4 ranks);

the bench entry point (proton_tpu_torch/bench.py; K1 on every cell of its
timed assembly):

25. [bench] run_bench(1024, 1) in this process at PROTON_BENCH_TOL=1e-11,
    with K1's launches and their cell counts read around it: two on all
    1,048,576 cells (the untimed and the timed assembly) and the lean
    path's (one cell and the displaced cells of every level, the counts
    phase 7b compared); CG exit 0, iterations within 2 of phase 7's
    solve and H1 within rtol 1e-6 of it (the same system and solver);
    then `python -m proton_tpu_torch.bench` in the stock form at
    PROTON_BENCH_N=128 as a subprocess: exit 0, the k=1 line, then the
    last line with the k=2 fields under "k2";

the JAX package's precision modes (cut/fictdom_structured.py: mixed,
mg_f32, cg_f64, cg_segment; K1 in float32 on their path):

26. [precision] (a) K1 in float32 against its plain version (max|diff| /
    max|plain| < 1e-4) at every shape the precision paths give it, level
    by level 1024^2 ... 8^2: one cell and the displaced cells at k=1 and
    k=2, the displaced cells of the float32 classification where their
    count differs, and every cell of the mixed 1024^2 mesh at k=1 and
    k=2; (b) mg_f32=True at 256^2 k=2, tol 1e-11, against phase 9's
    solution (local dofs within 2e-8 of max|local|, H1 rtol 1e-4); (c) the
    same at 512^2 k=1 against phase 8's (local dofs 2e-8, H1 2e-3), and
    torch.profiler over 10 of its iterations beside phase 10's; (d) the
    mixed library solve at 1024^2 k=1 and k=2, tol 1e-6: CG exit 0,
    finite float32 local dofs, K1's float32 launches on the displaced
    cells of every level, the H1 error within MIXED_H1_LIMITS (k=1:
    within a factor 2 of the JAX package's TPU reading; k=2: below a
    limit between the sound runs' readings and a control's); (e)
    cg_segment=50 in the float32 solve at 1024^2 k=1, tol 1e-6: exit 0,
    H1 below F32_H1_LIMIT; (f) run_bench(1024, 2) with
    PROTON_BENCH_PRECISION=mixed (K1 in float32 on every cell twice),
    then the bench CLI at 128^2 for each precision: exit 0 and the JAX
    bench's label; (g) the JAX package's CPU numbers at 16^2
    (PRECISION_GATES);

the multigrid options the JAX package keeps off by default
(solvers/multigrid.py: cheb_ops, the smoothed and the cut-aware
transfers, the interface-band deflation; K1 on the lean path's shapes):

27. [mg_options] k=1, lean + MG, tol 1e-11, one solve per option of
    MG_OPTIONS: mg_transfer="smoothed" and mg_deflate=4 at 1024^2,
    cheb_ops="uniform" at 256^2, mg_transfer="cut" and cheb_ops="mixed"
    at 128^2 (their counts grow too fast for 1024^2: 4,255 and 13,657
    iterations there for cheb_ops, 1,405 at 512^2 for "cut"):
    iterations, ms per iteration, setup seconds (drec_setup_s,
    deflate_setup_s), peak GB, K1's launches and cell counts; each held
    to the default solve of the same system (phase 7's at 1024^2, phase
    22's at 256^2 and 128^2, reused): CG exit 0, local dofs within 2e-8
    of max|local|, H1 rtol 2e-3; mg_deflate=4 at 256^2 k=2 and "cut" at
    64^2 k=2 (tol 1e-12; 1,864 iterations at 256^2) against phase 9's
    solves the same way; the bench CLI at PROTON_BENCH_N=128, k=1, twice
    (MG_OPTIONS_CLI: each value of MGTRANSFER, DEFLATE and CHEBOPS in
    one run; beside the k=2 runs: exit 0, the line's "options" name the
    keywords); the family app with PROTON_TPU_X64=0 at
    -N 256 -k 1 -B 8 (all converged, no overflow, 8 float32 K1
    launches on all 65,536 cells, each geometry's H1 below
    FAMILY_F32_H1_LIMIT, printed beside phase 21's float64 run of the
    same radii), and K1 in float32 against its plain version on its first
    geometry's displaced mesh;

the package namespace (proton_tpu_torch/__init__.py, the names of
proton_tpu/__init__.py; no kernel of its own):

28. [namespace] the library sample of the verify notes through
    ``import proton_tpu_torch as pt`` with no device given (so on the
    card): pt.make_quad_mesh, pt.HHODegreeInfo(2, 1),
    pt.assembly.build_dofmap, poisson.solve_poisson and compute_errors on
    sin(pi x) sin(pi y) at N = 8, 16, 32; the L2 and energy orders within
    0.2 of 3 and 2, the boundary codes and __version__ those of the JAX
    package, and K1 launched no time.

Every phase prints its seconds (`[phase]`). To fit the 1,000 s budget,
depth was cut: the fictdom_family app runs at -B 8 (was 64) and its
ellipse and flower families at B=2 (was 4); phase 17's order is taken
from 128^2 to 256^2 (the 512^2 solve is gone); phases 10 and 18 profile
10 iterations (was 20); phase 23 reuses the rediscretized solutions of
phases 7 and 9 instead of solving again, profiles on the 1024^2 k=2
solve's Galerkin hierarchy, and runs mg_gamma=2 only at the JAX gate's
32^2 (tools/galerkin_history.py --gamma 2 measures it at 256^2 and
512^2). For phase 26: phase 9 no longer solves 512^2 k=2 (its H1 order
is taken from 256^2 to 1024^2 over two doublings), so phase 23 holds the
Galerkin solve against the rediscretized one at 256^2 and 1024^2 only;
phase 21's 1024^2 family has one geometry (was two, FAMILY_RADII);
phase 26 runs its in-process mixed bench at tol BENCH_MIXED_TOL and its
three bench CLI runs at once, beside (d)-(f) (after every kernel timing
and profile); phase 25's CLI run goes beside its in-process run_bench.
For phase 27 (the script read 1,282-1,400+ s with it and the earlier
depth; the host of an H100 paces the V-cycle at 52-78 ms an iteration,
from run to run):
phase 26 (b) runs mg_f32 k=2 at 256^2 (was 1024^2: 1,998 iterations,
~104 s) and (c) its k=1 solve at 512^2 against phase 8's (was 1024^2,
against phase 7's; the profile stays at 1024^2); phase 23 no longer
solves Galerkin k=2 at 1024^2 (802 iterations, ~100 s with its 11.6 s
setup) and profiles at 256^2 k=2; phase 18's interface runs at 256^2
and 512^2 (its order over that doubling; 1024^2 read 532 iterations,
34 s) and profiles at 512^2; phase 22's damped smoothers run at 64^2
(was 128^2: 413 / 449 iterations, 24 s); phase 21's pair of geometries
against the structured solve runs at 128^2 (was 256^2).

Any failed check raises, so the script exits non-zero and prints no
result. Without a CUDA device it exits non-zero before any phase. The
second-to-last line is the kernels' JSON record (K1 at k=1 with the
block-Jacobi main path's launches, at k=2 with the 256^2 solve's, at the
lean path's shape with the launches of the 1024^2 lean + multigrid solve,
at k=1 and at k=2, at the 512^2 classified mesh with the launches of the
full + multigrid solve, at one family geometry's displaced 1024^2 mesh
with the launches of the 1024^2 family, and at the lean path's shape with
the launches of the 1024^2 k=1 and the 256^2 k=2 Galerkin solves (the
k=2 row at 256^2's displaced cells), and at
every cell of the classified 1024^2 mesh with the launches of phase 25's
bench run; in float32, at the displaced 1024^2 cells with the float32
launches of phase 26's mixed k=1 and k=2 solves and of its float32 k=1
solve, and at
every cell of the mixed mesh at k=2 with those of its mixed bench run;
phase 27's: at the lean path's shape with the launches of its k=1 option
solves and of its k=2 ones, and in float32 at the family's displaced 256^2
mesh with the float32 family app's), the last line {"ok": true,
"device": {...}}.
"""

import json
import math
import re
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

# (iterations, H1) of the JAX package on the CPU in float64 at 32^2 k=1,
# solve_fictdom_structured(32, 1, precond="block_jacobi", fitted="full",
# mixed=False, use_pallas=False), CG tol 1e-10, divergence 1e8,
# max_iter 50000 (the port's CPU gate, tests/test_torch_solve.py).
GATE_32 = (115, 1.1344765273981145e-3)

# The same with precond="mg", fitted="lean" (the defaults of the port):
# N -> (iterations, H1), CG tol 1e-10.
MG_GATES = {32: (15, 1.134476548999272e-3), 64: (31, 2.9134002094604466e-4)}

# The same at k=2 and CG tol 1e-12. From 128^2 on the JAX package's k=2 H1
# error stops falling at the cubic rate (1.80e-4, 2.29e-5, 3.51e-6,
# 1.73e-6 at 16^2 ... 128^2; the port's numbers are the same). The two
# packages agree there to 5e-5 relative, so the H1 gate at k=2 is rtol
# 1e-4.
MG_GATES_K2 = {64: (79, 3.511861908955221e-6),
               128: (166, 1.7251244624837503e-6)}

# The JAX package on the CPU in float64: (L2, L2 projection, energy, CG
# iterations) of the convergence study's solve, HHODegreeInfo(k + 1, k),
# HHO stabilization, Jacobi PCG at tol 1e-12, max_iter 3 * n_dofs (the
# loop of proton_tpu/apps/convergence_test.py with write_files=False; they
# equal RESULTS.md:14-33 to its three digits):
#   solve_poisson(make_quad_mesh(Nx=N, Ny=N), build_dofmap(mesh, hdi), hdi,
#                 rhs, sol, "hho", cgp); compute_errors(mesh, hdi, s, sol,
#                 grad)
CONVERGENCE_GATES = {
    (0, 16): (0.013701639764531252, 0.01360735074042245,
              0.17797381888468272, 3),
    (0, 32): (0.0034297752773830457, 0.003406195247076536,
              0.08902274419419968, 3),
    (1, 16): (0.0003510074491135749, 0.00034626374512449794,
              0.008642172473482673, 10),
    (1, 32): (4.31639460481676e-05, 4.255989317592748e-05,
              0.0021243470741231906, 14),
    (2, 16): (1.4585359731267815e-05, 1.4517540014975812e-05,
              0.0002662853331792258, 34),
    (2, 32): (9.1305997389951e-07, 9.088202960204327e-07,
              3.331395357478813e-05, 38),
    (3, 16): (3.826580195194054e-07, 3.8170970970345493e-07,
              6.582203369613157e-06, 115),
    (3, 32): (1.1973116674337884e-08, 1.19434692823322e-08,
              4.116147997199549e-07, 132)}

# Energy errors of the reference's stored obstacle table
# (apps/obstacle/results/convergence.txt:1-5, BASELINE.md:12-13).
OBSTACLE_TABLE = {0: {8: 2.26205, 16: 1.2833, 32: 0.650286, 64: 0.326314,
                      128: 0.163344},
                  1: {8: 0.197735, 16: 0.0588187, 32: 0.0171607,
                      64: 0.00529786, 128: 0.00168321}}

# The JAX package on the CPU in float64, proton_tpu/apps/polymesh.py's
# solve (HHODegreeInfo(k, k), Jacobi PCG at tol 1e-12, max_iter
# 3 * n_dofs) on the 16 x 16 brick mesh of
# proton_tpu_torch/tools/brick_mesh.py: (L2 error against the projection,
# CG iterations). At 32 x 32 bricks: 0.0027157896578157386 (k=0) and
# 5.099341984178092e-05 (k=1), orders 1.99 and 2.99.
BRICK16_GATES = {0: (0.010804982244290178, 79),
                 1: (0.00040385578148711607, 195)}

# The generic cut path (phases 16-20). The JAX package on the CPU in
# float64, (CG iterations, H1 error):
#   proton_tpu.cut.fictdom.run_fictdom(N, k) (Jacobi PCG, tol 1e-12) and
#   proton_tpu.cut.interface_problem.run_interface(N, k) (condensed +
#   uniform MG + cut-band Schwarz, tol 1e-9), with their defaults.
FICTDOM_GATES = {(16, 1): (333, 4.434838976686683e-3),
                 (32, 1): (1115, 1.1344765305280414e-3),
                 (16, 2): (1306, 1.7830932491347257e-4)}
INTERFACE_GATES = {(16, 0): (23, 0.1792588524007485),
                   (16, 1): (20, 8.071813328813876e-3),
                   (32, 0): (34, 8.968602232006512e-2),
                   (32, 1): (27, 2.07579419658458e-3),
                   (16, 2): (18, 2.705311510189856e-4)}
# At 16^2 k=2 the fictdom Jacobi-PCG count moves with rounding of the
# operator: the port's CG on the JAX package's local matrices (1.3e-12
# relative from the port's) stops after 1,328 iterations, on its own
# after 1,303, the JAX package's after 1,306 (CPU, float64). So k=2
# counts are held to 2.5%, k=1 counts to 2.
FICTDOM_K2_ITERATIONS = 0.025
# The cuthho_square app at the BASELINE configuration (-M 64 -N 64 -k 1,
# BASELINE.md:25-26): the JAX app's energy-norm errors of -i (39 CG
# iterations) and -f (2,754), CPU, float64.
APP_GATES_64 = {"interface": 5.2344414006883e-4,
                "fictdom": 2.913400189898017e-4}

# Phase 13: the full and the condensed 1024^2 k=1 solutions may differ by
# this share of max|u|. Both stop at ||r|| < 1e-12 ||b||, which bounds the
# error of each by cond(A) x 1e-12 relative: with cond ~ N^2 that bound is
# ~1e-6 at 1024^2, far above what the solves leave. On the CPU (the port,
# float64) the two agree to 2.4e-14, 1.7e-13 and 6.2e-13 at 64^2, 128^2
# and 256^2 (x2.7-7 per doubling: at most ~3e-11 at 1024^2). 1e-9 keeps a
# factor 30 over that and stays below the L2 discretization error there
# (~1.3e-9, k=1), so a difference that passes cannot move the orders.
POISSON_AGREEMENT = 1e-9

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


_STAGE = re.compile(r"mg_([a-z]+)_n\d+_s$")
_CG_TOTALS = ("cg_apply_s", "cg_precond_s", "cg_wait_s", "cg_self_s",
              "cg_precond_calls", "solve_self_s")


def span_summary(t: dict) -> dict:
    """A timings dict as a line prints it: the phases' seconds, CG's
    totals (cg_apply_s, cg_precond_s, cg_wait_s, cg_self_s,
    cg_precond_calls) and solve_self_s, and each V-cycle stage's seconds
    summed over the levels (mg_<stage>_s), rounded."""
    out = {k: v for k, v in t.items()
           if k.endswith("_s") and not k.endswith("_self_s") and
           not _STAGE.match(k) and not k.startswith(("cg_", "galerkin."))}
    out.update((k, t[k]) for k in _CG_TOTALS if k in t)
    for k, v in t.items():
        m = _STAGE.match(k)
        if m:
            key = f"mg_{m.group(1)}_s"
            out[key] = out.get(key, 0.0) + v
    return {k: round(v, 4) for k, v in out.items()}


_PHASE_START = [time.perf_counter()]


def phase_done(name: str) -> None:
    """Print the seconds since the previous phase ended."""
    now = time.perf_counter()
    line("phase", name=repr(name), seconds=round(now - _PHASE_START[0], 3))
    _PHASE_START[0] = now


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
    turn as cut/fictdom_structured.py:assemble_level_cl runs them, with a
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
    mesh, _, _, cell_loc, batch, _ = fs.classify_cells(N, problem, 4,
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


def solve(N: int, k: int, tol: float, fitted: str = "full",
          precond: str = "block_jacobi", device: str = "cuda",
          cap: Optional[int] = None, **options):
    """One end-to-end solve with its numbers printed and its result
    checked: converged below tol, finite local dofs of the right shape,
    a finite H1 error. ``options`` go to solve_fictdom_structured. With
    ``cap``, CG stops after about cap iterations and may end there (exit
    2): the caller then gates the residual."""
    from proton_tpu_torch.cut import fictdom_structured as fs
    from proton_tpu_torch.solvers import cg

    params = cg.CGParams(convergence_threshold=tol,
                         divergence_threshold=1e8,
                         max_iter=50000 if cap is None else cap,
                         apply_preconditioner=True)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    options.setdefault("dtype", torch.float64)
    t0 = time.perf_counter()
    r = fs.solve_fictdom_structured(N, k, fitted=fitted, precond=precond,
                                    cg_params=params, device=device,
                                    **options)
    wall = time.perf_counter() - t0
    d = (k + 2) * (k + 3) // 2 + 4 * (k + 1)
    line("solve", N=N, k=k, fitted=fitted, precond=precond, **options,
         tol=tol,
         exit=r.exit_reason, iterations=r.iterations, rel=r.rel_residual,
         h1=r.h1_error,
         ms_per_iteration=1e3 * r.timings["cg_s"] / max(r.iterations, 1),
         wall_s=wall,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
         **span_summary(r.timings))
    if cap is None:
        check(r.exit_reason == cg.CONVERGED and r.rel_residual < tol,
              f"{N}^2 k={k}: exit {r.exit_reason}, rel {r.rel_residual}")
    else:
        check(r.exit_reason in (cg.CONVERGED, cg.MAX_ITER_REACHED),
              f"{N}^2 k={k}: exit {r.exit_reason}, rel {r.rel_residual}")
    check(tuple(r.local.shape) == (N * N, d) and
          bool(torch.isfinite(r.local).all()), f"{N}^2 k={k}: local")
    check(math.isfinite(r.h1_error), f"{N}^2 k={k}: H1 {r.h1_error}")
    return r


def counted_solve(tag: str, *args, **kw):
    """solve() with K1's launch count set to 0 just before and read just
    after: (result, launches, the cell counts of those launches)."""
    from proton_tpu_torch.methods import fused_assembly as fa

    fa.reset_launch_counts()
    r = solve(*args, **kw)
    launches = fa.fused_local_operator.launches
    cells = list(fa.fused_local_operator.launch_cells)
    line(tag, kernel="fused_local_operator", launches=launches,
         launch_cells=",".join(map(str, cells)))
    return r, launches, cells


def kernel_row(x, cd: int, fd: int, tol: float, bw: float, flop_peak: float,
               reps: int = 20, plain_reps: int = 3) -> dict:
    """K1 on the packed inputs x against its plain version: the check
    (max|diff| / max|plain| < tol), both times, and the bound for these
    inputs on this card. Prints the [kernel] line, returns the record's
    measured keys."""
    from proton_tpu_torch.methods import fused_assembly as fa

    dtype, C = x[0].dtype, x[0].shape[-1]
    out = fa.fused_local_operator(*x, cd, fd)
    torch.cuda.synchronize()
    ref = fa.fitted_local_operator_plain(*x, cd, fd)
    max_abs = float((out - ref).abs().max())
    rel = max_abs / float(ref.abs().max())
    del out, ref
    ms = cuda_ms(lambda: fa.fused_local_operator(*x, cd, fd), reps)
    plain_ms = cuda_ms(lambda: fa.fitted_local_operator_plain(*x, cd, fd),
                       plain_reps)
    d = (cd + 1) * (cd + 2) // 2 + 4 * (fd + 1)
    nbytes = (40 + d * d) * (torch.finfo(dtype).bits // 8) * C
    bytes_ms = nbytes / bw * 1e3
    flop_ms = k1_flops_per_cell(cd, fd) * C / flop_peak * 1e3
    bound_ms = max(bytes_ms, flop_ms)
    bound_by = "bytes" if bytes_ms >= flop_ms else "operations"
    line("kernel", name="fused_local_operator", k=fd, cell_degree=cd,
         face_degree=fd, dtype=str(dtype).split(".")[1], cells=C,
         max_rel_err=rel, max_abs_err=max_abs, tol=tol, ms=ms,
         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
         bytes_ms=bytes_ms, flop_ms=flop_ms, bound_share=bound_ms / ms,
         gb_per_s=nbytes / ms / 1e6)
    check(rel < tol, f"K1 <{cd},{fd}> {dtype} at {C} cells: rel err {rel} "
          f">= {tol}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def path_inputs(n: int, device: str = "cuda"):
    """K1's packed inputs at the three shapes the solve paths give it on
    the n^2 level: the unit cell (one cell of side 1/n), the cells whose
    nodes the bad-cut displacement moved (both fitted="lean"), and every
    cell of the classified mesh (fitted="full")."""
    from proton_tpu_torch.core.geometry import cell_geometry
    from proton_tpu_torch.core.mesh import unit_cell_mesh
    from proton_tpu_torch.cut import fictdom_structured as fs
    from proton_tpu_torch.methods import fused_assembly as fa

    mesh1 = unit_cell_mesh(1.0 / n, device=device)
    unit = fa.pack_inputs(mesh1, cell_geometry(mesh1))
    mesh, _, _, _, _, dist_ids = fs.classify_cells(
        n, fs.default_problem(), 4, device=torch.device(device))
    geom = cell_geometry(mesh)
    sub, gsub = fs._gather_cells(
        mesh, geom, torch.as_tensor(dist_ids, device=mesh.points.device))
    return unit, fa.pack_inputs(sub, gsub), fa.pack_inputs(mesh, geom)


def path_shape_rows(N: int, coarsest: int, bw: float, flop_peak: float):
    """K1 against its plain version at every shape the solve paths of
    this script give it, level by level over N, N/2, ..., coarsest: the
    unit cell and the displaced cells at k=1 and k=2 (the lean solves and
    their multigrid levels), every cell of the classified mesh at k=1 (the
    full solves and the full multigrid levels) and, at 256^2, at k=2.
    Returns ({(shape, n, k): record row}, the displaced-cell counts by
    level)."""
    from proton_tpu_torch.solvers.multigrid import _mg_sizes

    rows, displaced_cells = {}, []
    for n in _mg_sizes(N, coarsest):
        unit, displaced, full = path_inputs(n)
        displaced_cells.append(displaced[0].shape[-1])
        fine = n == N
        for k in (1, 2):
            reps = dict(reps=200 if fine else 20, plain_reps=20 if fine else 3)
            rows[("unit", n, k)] = kernel_row(unit, k + 1, k, 1e-11, bw,
                                              flop_peak, **reps)
            rows[("displaced", n, k)] = kernel_row(displaced, k + 1, k, 1e-11,
                                                   bw, flop_peak, **reps)
        rows[("full", n, 1)] = kernel_row(full, 2, 1, 1e-11, bw, flop_peak,
                                          reps=10, plain_reps=2)
        if n == 256:
            rows[("full", n, 2)] = kernel_row(full, 3, 2, 1e-11, bw,
                                              flop_peak, reps=10,
                                              plain_reps=2)
        del unit, displaced, full
        torch.cuda.empty_cache()
    return rows, displaced_cells


def check_lean_launches(what: str, cells, displaced_cells) -> None:
    """The lean solve launched K1 on a unit cell and on the displaced
    cells of every level, at the cell counts path_shape_rows compared."""
    check(1 in cells and sorted(c for c in cells if c > 1) ==
          sorted(displaced_cells),
          f"{what} launched K1 at {cells}, compared at the displaced cell "
          f"counts {displaced_cells}")


def host_traffic(events, iterations: int, labels=()):
    """(scalar reads per iteration, host-to-device copies) of a
    torch.profiler window over `iterations` CG iterations."""
    from torch.autograd import DeviceType

    cpu_side = {e.key: e for e in events if e.device_type == DeviceType.CPU}
    reads = cpu_side["aten::_local_scalar_dense"].count / iterations \
        if "aten::_local_scalar_dense" in cpu_side else 0.0
    h2d = sum(e.count for e in events if e.device_type == DeviceType.CUDA
              and e.key not in labels and "HtoD" in e.key)
    return reads, h2d


def profile_mg(N: int, k: int, iterations: int, device: str = "cuda",
               galerkin: bool = False, tag: str = "profile_mg",
               mg_f32: bool = False) -> dict:
    """torch.profiler over `iterations` multigrid-PCG iterations of the
    lean N^2 system (with ``galerkin``, over the Galerkin hierarchy
    galerkin_levels builds from the same levels; its apply's conv and
    deviation pairs are then split by level too; with ``mg_f32``, the
    float32 V-cycle, its casts at the boundary inside `vcycle`). Every
    callable of the V-cycle is labelled with its level and kind, so the
    device time splits by region and by level:
    `cheb` (the Chebyshev smoother with its own operator and block-Jacobi
    applies), `apply` (the V-cycle's residual operator applies), `patch`,
    `restrict`, `prolong`, `coarse_solve`, CG's operator apply, and the
    rest (CG's dots and axpys, the V-cycle's vector sums). Also kernel
    launches per iteration, the device's busy share, scalar reads and
    host-to-device copies per iteration. Returns the device microseconds
    per iteration by region ("device", "vcycle", "cg_apply_S", the kinds
    and "L<n>" per level), "launches" and "busy" ({} where the profiler
    saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from proton_tpu_torch.core.ops import HHODegreeInfo
    from proton_tpu_torch.cut import fictdom_structured as fs
    from proton_tpu_torch.solvers import cg, multigrid

    on_card = torch.device(device).type == "cuda"
    hdi, problem, eta = HHODegreeInfo(k + 1, k), fs.default_problem(), \
        fs.nitsche_eta(k)
    fine = fs.build_level(N, hdi, problem, eta, 4, device=device,
                          fitted="lean")
    levels = {N: fine, **fs.build_coarse_levels(N, hdi, problem, eta, 4,
                                                device=device)}
    fsys = fs.face_system(fine, N, hdi, problem, "mg", device=device)
    gal = galerkin_levels(N, k, levels) if galerkin else None
    mg_dtype = torch.float32 if mg_f32 else torch.float64
    mg = fs.level_multigrid(levels, hdi, galerkin=gal, dtype=mg_dtype)
    del levels, gal

    labels = []

    def labelled(name, fn):
        labels.append(name)

        def call(x):
            with record_function(name):
                return fn(x)
        return call

    wrapped = []
    for lev in mg.levels:
        n = lev.sys.Nx
        steps = tuple(labelled(f"L{n}.{'cheb' if i == 0 else 'patch'}", s)
                      for i, s in enumerate(lev.smoothers))
        wrapped.append(multigrid.MGLevel(
            lev.sys, labelled(f"L{n}.apply", lev.apply_S), steps,
            lev.prolong and labelled(f"L{n}.prolong", lev.prolong),
            lev.restrict and labelled(f"L{n}.restrict", lev.restrict)))
    mg = mg._replace(levels=wrapped)
    # the Galerkin apply's own spans (multigrid.make_galerkin_operator_cl)
    labels += ["galerkin.conv", "galerkin.pairs"]
    vcycle = labelled("vcycle", fs._in_dtype(mg.precondition, mg_dtype))
    apply_S = labelled("cg.apply_S", fsys.apply_S)

    def run(n):
        # tol 0 never converges: exactly n iterations, exit 2
        return cg.conjugated_gradient(apply_S, fsys.rhs, None,
                                      cg.CGParams(0.0, 1e8, n - 2, True),
                                      precond=vcycle)

    run(3)
    activities = [ProfilerActivity.CPU]
    if on_card:
        torch.cuda.synchronize()
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        res = run(iterations)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(res.iterations == iterations, "profile window length")
    events = prof.key_averages()
    cpu_side = {e.key: e for e in events if e.device_type == DeviceType.CPU}
    per_it = lambda v: v / iterations
    scalar_reads, h2d = host_traffic(events, iterations, labels)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.key not in labels]
    # run() reads one scalar per iteration (the exit test); the vcycle
    # runs once less than the iterations (none after the last test)
    line(f"{tag}_host", N=N, k=k, iterations=iterations,
         ms_per_iteration=1e3 * wall / iterations,
         scalar_reads_per_iteration=scalar_reads,
         host_to_device_copies=h2d,
         vcycles=cpu_side["vcycle"].count if "vcycle" in cpu_side else 0)
    check(scalar_reads == 1.0, f"{scalar_reads} scalar reads per iteration")
    check(h2d == 0, f"{h2d} host-to-device copies in the window")
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us == 0:
        line(tag, N=N, k=k, device_time="not measured")
        check(not on_card, "the profiler saw no device time on the card")
        return {}
    region = {name: cpu_side[name].device_time_total for name in labels
              if name in cpu_side}
    launches = sum(e.count for e in kernels)
    vc = region.pop("vcycle", 0.0)
    cg_apply = region.pop("cg.apply_S", 0.0)
    line(tag, N=N, k=k, iterations=iterations,
         ms_per_iteration=1e3 * wall / iterations,
         device_us_per_iteration=per_it(device_us),
         kernel_launches_per_iteration=per_it(launches),
         device_busy_share=device_us / 1e6 / wall,
         vcycle_us=per_it(vc), cg_apply_S_us=per_it(cg_apply),
         cg_own_ops_us=per_it(device_us - vc - cg_apply))
    kinds = {kind: sum(v for name, v in region.items()
                       if name.endswith("." + kind))
             for kind in ("cheb", "apply", "patch", "restrict", "prolong")}
    coarse = vc - sum(kinds.values())
    line(f"{tag}_region", **{f"{kind}_us": per_it(v)
                                 for kind, v in kinds.items()},
         coarse_solve_and_vector_sums_us=per_it(coarse))
    summary = dict(device=per_it(device_us), vcycle=per_it(vc),
                   cg_apply_S=per_it(cg_apply),
                   launches=per_it(launches), busy=device_us / 1e6 / wall,
                   coarse_solve_and_vector_sums=per_it(coarse),
                   **{kind: per_it(v) for kind, v in kinds.items()})
    for lev in wrapped[:-1]:     # the coarsest level is the dense solve
        n = lev.sys.Nx
        mine = {name.split(".")[1]: v for name, v in region.items()
                if name.startswith(f"L{n}.")}
        summary[f"L{n}"] = per_it(sum(mine.values()))
        line(f"{tag}_level", n=n,
             level_us=per_it(sum(mine.values())),
             **{f"{kind}_us": per_it(v) for kind, v in mine.items()})
    ops = [e for e in cpu_side.values()
           if e.key.startswith("aten::") and e.self_device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:8]:
        line(f"{tag}_op", op=e.key,
             calls_per_iteration=per_it(e.count),
             device_us_per_iteration=per_it(e.self_device_time_total),
             share=e.self_device_time_total / device_us)
    if galerkin:
        galerkin_split(prof.events(), iterations, tag)
    return summary


def galerkin_split(events, iterations: int, tag: str) -> None:
    """Device time of the Galerkin apply's two parts (its
    `galerkin.conv` and `galerkin.pairs` spans) by level: each span is
    charged to the level label (`L<n>.<kind>`) it runs under."""
    from torch.autograd import DeviceType

    split = {}
    for e in events:
        if e.name not in ("galerkin.conv", "galerkin.pairs") or \
                e.device_type != DeviceType.CPU:
            continue
        p = e.cpu_parent
        while p is not None and not re.match(r"L\d+\.", p.name):
            p = p.cpu_parent
        n = int(p.name[1:].split(".")[0]) if p is not None else -1
        key = (n, e.name.split(".")[1])
        calls, us = split.get(key, (0, 0.0))
        split[key] = (calls + 1, us + e.device_time_total)
    for n in sorted({n for n, _ in split}, reverse=True):
        conv, pairs = split.get((n, "conv"), (0, 0.0)), \
            split.get((n, "pairs"), (0, 0.0))
        line(f"{tag}_galerkin_apply", n=n,
             applies_per_iteration=conv[0] / iterations,
             conv_us_per_iteration=conv[1] / iterations,
             pairs_us_per_iteration=pairs[1] / iterations,
             conv_us_per_apply=conv[1] / max(conv[0], 1),
             pairs_us_per_apply=pairs[1] / max(pairs[0], 1))


def hho_vs_k1(N: int, bw: float) -> None:
    """Phase 11: the generic operators on the N^2 quad mesh. For k=1 and
    k=2: hho_laplacian's data + naive_stabilization against K1 (the same
    function on quads), then the time (CUDA events) and the peak memory
    of hho_laplacian + fancy_stabilization, the uncut path's operator."""
    from proton_tpu_torch.core.geometry import cell_geometry
    from proton_tpu_torch.core.mesh import make_quad_mesh
    from proton_tpu_torch.core.ops import HHODegreeInfo
    from proton_tpu_torch.methods import fused_assembly as fa
    from proton_tpu_torch.methods import hho

    mesh = make_quad_mesh(Nx=N, Ny=N, device="cuda")
    geom = cell_geometry(mesh)
    for k in (1, 2):
        hdi = HHODegreeInfo(k + 1, k)
        k1 = fa.fused_local_operator(*fa.pack_inputs(mesh, geom), k + 1, k)
        lc = hho.hho_laplacian(mesh, geom, hdi)[1]
        lc += hho.naive_stabilization(mesh, geom, hdi)
        d = lc.shape[1]
        generic = lc.permute(1, 2, 0).reshape(d * d, -1)
        max_abs = float((generic - k1).abs().max())
        rel = max_abs / float(k1.abs().max())
        del k1, lc, generic
        torch.cuda.empty_cache()

        def fancy():
            oper, data = hho.hho_laplacian(mesh, geom, hdi)
            return data + hho.fancy_stabilization(mesh, geom, hdi, oper)

        def naive():
            lc = hho.hho_laplacian(mesh, geom, hdi)[1]
            return lc + hho.naive_stabilization(mesh, geom, hdi)

        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = cuda_ms(fancy, 3)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        naive_ms = cuda_ms(naive, 3)
        out_gb = N * N * d * d * 8 / 1e9
        line("hho", N=N, k=k, d=d, naive_vs_k1_max_rel_err=rel,
             naive_vs_k1_max_abs_err=max_abs, tol=1e-11,
             laplacian_fancy_ms=ms, laplacian_naive_ms=naive_ms,
             peak_gb=peak, lc_gb=out_gb,
             lc_write_bound_ms=out_gb * 1e9 / bw * 1e3)
        check(rel < 1e-11, f"k={k}: generic naive path differs from K1 by "
              f"{rel}")
        torch.cuda.empty_cache()


def convergence_table() -> None:
    """Phase 12: the BASELINE study (convergence_test.cpp's), k=0..3,
    N=16..256, Jacobi PCG at tol 1e-12, against the JAX package's CPU
    numbers at N=16 and 32 and the orders k+2 / k+1 from 64^2 to 128^2.
    k=3 at 256^2 sits at the float64 floor (RESULTS.md:35-38): printed,
    not gated."""
    from proton_tpu_torch.apps import convergence_test as ct

    t0 = time.perf_counter()
    rows = ct.test_method_convergence(
        ct.ConvergenceTestParams(deg_min=0, deg_max=3, min_N=16, steps=5),
        write_files=False, device="cuda")
    for k, krows in rows.items():
        for i, r in enumerate(krows):
            N = 16 << i
            line("convergence", k=k, N=N, l2=r.l2, l2_proj=r.l2_proj,
                 energy=r.energy, iterations=r.iterations, seconds=r.seconds)
            if (k, N) in CONVERGENCE_GATES:
                ref = CONVERGENCE_GATES[(k, N)]
                for name, a, b in zip(("L2", "L2 projection", "energy"),
                                      r[:3], ref[:3]):
                    check(math.isclose(a, b, rel_tol=1e-6),
                          f"k={k} N={N}: {name} error {a}, JAX {b}")
                check(abs(r.iterations - ref[3]) <= 2,
                      f"k={k} N={N}: {r.iterations} iterations, JAX {ref[3]}")
        l2 = math.log2(krows[2].l2 / krows[3].l2)
        en = math.log2(krows[2].energy / krows[3].energy)
        line("convergence_order", k=k, l2_64_128=l2, energy_64_128=en,
             l2_128_256=math.log2(krows[3].l2 / krows[4].l2),
             energy_128_256=math.log2(krows[3].energy / krows[4].energy))
        check(k + 1.8 <= l2 <= k + 2.2, f"k={k}: L2 order {l2}")
        check(k + 0.8 <= en <= k + 1.2, f"k={k}: energy order {en}")
    line("convergence_total", seconds=time.perf_counter() - t0)


def _sin_problem():
    pi = math.pi

    def sol(p):
        return torch.sin(pi * p[..., 0]) * torch.sin(pi * p[..., 1])

    def grad(p):
        return torch.stack(
            [pi * torch.cos(pi * p[..., 0]) * torch.sin(pi * p[..., 1]),
             pi * torch.sin(pi * p[..., 0]) * torch.cos(pi * p[..., 1])], -1)

    return (lambda p: 2 * pi ** 2 * sol(p)), sol, grad


def poisson_solves(N: int, k: int, tol: float):
    """Phase 13 at one size: the full (cell + face) system with
    solve_poisson and the condensed face system with solve_condensed
    (gather form), each timed by phase and checked converged. Returns
    {form: (local, errors)}."""
    from proton_tpu_torch.core.geometry import cell_geometry
    from proton_tpu_torch.core.mesh import make_quad_mesh
    from proton_tpu_torch.core.ops import HHODegreeInfo, cell_rhs
    from proton_tpu_torch.methods import assembly, condensation, poisson
    from proton_tpu_torch.solvers import cg
    from proton_tpu_torch.utils.timing import sink, span

    rhs, sol, grad = _sin_problem()
    hdi = HHODegreeInfo(k + 1, k)
    params = cg.CGParams(convergence_threshold=tol, divergence_threshold=1e8,
                         max_iter=200000, apply_preconditioner=True)
    dev = torch.device("cuda")
    mesh = make_quad_mesh(Nx=N, Ny=N, device=dev)
    out = {}
    for form in ("full", "condensed"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t, t0 = {}, time.perf_counter()
        with sink(t):
            with span("dofmap", dev):
                dm = assembly.build_dofmap(mesh, hdi)
            if form == "full":
                s = poisson.solve_poisson(mesh, dm, hdi, rhs, sol, "hho",
                                          params, timings=t)
                its, exit_code = s.iterations, s.exit_reason
            else:
                with span("geometry", dev):
                    geom = cell_geometry(mesh)
                with span("local_operators", dev):
                    oper, lc = poisson.assemble_local(mesh, geom, hdi)
                with span("rhs", dev):
                    f = cell_rhs(mesh, geom, hdi.cell_degree, rhs)
                    g = assembly.local_dirichlet_data(
                        dm, mesh, assembly.dirichlet_face_data(mesh, hdi, sol))
                    inc = assembly.build_face_incidence(mesh, dm)
                local, res = condensation.solve_condensed(dm, lc, f, g, inc,
                                                          params, timings=t)
                del lc
                s = poisson.PoissonSolution(res.x, local, oper, res.iterations,
                                            res.exit_reason, res.rel_residual,
                                            None)
                its, exit_code = res.iterations, res.exit_reason
            with span("errors", dev):
                e = poisson.compute_errors(mesh, hdi, s, sol, grad)
                errs = tuple(float(v) for v in e)
        line("poisson", N=N, k=k, form=form, tol=tol, exit=exit_code,
             iterations=its, ms_per_iteration=1e3 * t["cg_s"] / max(its, 1),
             l2=errs[0], l2_proj=errs[1], energy=errs[2],
             wall_s=time.perf_counter() - t0,
             peak_gb=torch.cuda.max_memory_allocated() / 1e9,
             **span_summary(t))
        check(exit_code == cg.CONVERGED, f"{N}^2 {form}: exit {exit_code}")
        check(bool(torch.isfinite(s.local).all()), f"{N}^2 {form}: local")
        out[form] = (s.local, errs)
        del s
    return out


def operator_applies(N: int, k: int) -> None:
    """The three operator forms of the uncut path at N^2 (CUDA events,
    one apply each on a random vector): the full system (gather, batched
    product, indexed-add scatter), and the condensed face system with the
    scatter and with the gather through the face incidence."""
    from proton_tpu_torch.core.geometry import cell_geometry
    from proton_tpu_torch.core.mesh import make_quad_mesh
    from proton_tpu_torch.core.ops import HHODegreeInfo
    from proton_tpu_torch.methods import assembly, condensation, poisson

    hdi = HHODegreeInfo(k + 1, k)
    mesh = make_quad_mesh(Nx=N, Ny=N, device="cuda")
    geom = cell_geometry(mesh)
    lc = poisson.assemble_local(mesh, geom, hdi)[1]
    dm = assembly.build_dofmap(mesh, hdi)
    S = condensation.condense(lc, lc.new_zeros((N * N, dm.cbs)), dm.cbs).S
    inc = assembly.build_face_incidence(mesh, dm)
    nfd = dm.n_dofs - N * N * dm.cbs
    x, xf = (torch.randn(n, dtype=torch.float64, device="cuda")
             for n in (dm.n_dofs, nfd))
    full = assembly.make_operator(dm, lc)
    scatter = condensation.make_condensed_operator(dm, None, S)
    gather = condensation.make_condensed_operator(dm, inc, S)
    check(float((scatter(xf) - gather(xf)).abs().max()) <=
          1e-12 * float(scatter(xf).abs().max()),
          "condensed scatter and gather applies differ")
    line("operator_apply", N=N, k=k, full_ms=cuda_ms(lambda: full(x), 20),
         condensed_scatter_ms=cuda_ms(lambda: scatter(xf), 20),
         condensed_gather_ms=cuda_ms(lambda: gather(xf), 20),
         full_dofs=dm.n_dofs, face_dofs=nfd,
         lc_gb=lc.numel() * 8 / 1e9, S_gb=S.numel() * 8 / 1e9)
    del lc, S
    torch.cuda.empty_cache()


def poisson_1024() -> None:
    """Phase 13: 1024^2 k=1 (and 512^2 for the orders), full against
    condensed. Both stop at a relative residual of 1e-12; the local
    solutions then differ by the algebraic error of the two solves."""
    operator_applies(1024, 1)
    r512 = poisson_solves(512, 1, 1e-12)
    r1024 = poisson_solves(1024, 1, 1e-12)
    full, cond = r1024["full"][0], r1024["condensed"][0]
    diff = float((full - cond).abs().max())
    umax = float(full.abs().max())
    line("poisson_full_vs_condensed", N=1024, max_abs_local_diff=diff,
         max_abs_u=umax, rel=diff / umax)
    check(diff <= POISSON_AGREEMENT * umax,
          f"1024^2: full and condensed local dofs differ by {diff}")
    del full, cond
    for form in ("full", "condensed"):
        (l2a, _, ena), (l2b, _, enb) = r512[form][1], r1024[form][1]
        l2, en = math.log2(l2a / l2b), math.log2(ena / enb)
        line("poisson_order", form=form, l2_512_1024=l2, energy_512_1024=en)
        check(2.8 <= l2 <= 3.2, f"{form}: L2 order {l2}")
        check(1.8 <= en <= 2.2, f"{form}: energy order {en}")
    del r512, r1024
    torch.cuda.empty_cache()


def obstacle_table() -> None:
    """Phase 14: run_obstacle(N, k) at the reference app's configuration
    against its stored table, with the active-set iterations, the CG
    iterations summed over them, and the seconds."""
    from proton_tpu_torch.methods import obstacle

    for k, table in OBSTACLE_TABLE.items():
        for N, ref in table.items():
            cg_its = []
            t0 = time.perf_counter()
            r = obstacle.run_obstacle(
                N, k, device="cuda",
                iteration_callback=lambda i, f: cg_its.append(
                    f["cg_iterations"]))
            err = float(r.energy_error)
            line("obstacle", N=N, k=k, energy_error=err, reference=ref,
                 rel=abs(err - ref) / ref, active_set_iterations=r.iterations,
                 cg_iterations=sum(cg_its), converged=r.converged,
                 seconds=time.perf_counter() - t0)
            check(r.converged, f"obstacle N={N} k={k} did not converge")
            check(abs(err - ref) / ref < 1e-4,
                  f"obstacle N={N} k={k}: energy error {err}, table {ref}")


def polymesh_bricks() -> None:
    """Phase 15: brick meshes written under build/ and loaded with
    load_poly_mesh on the card, solved as apps/polymesh.py does at
    HHODegreeInfo(k, k): the 16^2 mesh against the JAX package's numbers,
    the L2 order (against the projection) from 256^2 to 512^2 bricks (the
    JAX package's 16 -> 32 orders: 1.99 at k=0, 2.99 at k=1)."""
    from pathlib import Path

    from proton_tpu_torch.apps import polymesh
    from proton_tpu_torch.tools.brick_mesh import write_brick_mesh

    out_dir = Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    err = {}
    for n in (16, 256, 512):
        path = out_dir / f"brick_{n}.txt"
        t0 = time.perf_counter()
        write_brick_mesh(path, n, n)
        write_s = time.perf_counter() - t0
        for k in (0, 1):
            torch.cuda.reset_peak_memory_stats()
            r = polymesh.run_polymesh(str(path), k, "cuda")
            err[(n, k)] = r.l2_proj
            npts = torch.bincount(r.mesh.cell_npts).tolist()
            line("polymesh", bricks=n, k=k, cells=r.mesh.num_cells,
                 faces=r.mesh.num_faces,
                 cells_by_vertices={i: c for i, c in enumerate(npts) if c},
                 l2_proj=r.l2_proj, iterations=r.sol.iterations,
                 exit=r.sol.exit_reason, write_s=write_s, load_s=r.load_s,
                 solve_s=r.solve_s,
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            check(r.sol.exit_reason == 0, f"bricks {n} k={k}: not converged")
            if n == 16:
                ref, ref_its = BRICK16_GATES[k]
                check(math.isclose(r.l2_proj, ref, rel_tol=1e-6),
                      f"bricks 16 k={k}: L2 {r.l2_proj}, JAX {ref}")
                check(abs(r.sol.iterations - ref_its) <= 2,
                      f"bricks 16 k={k}: {r.sol.iterations} iterations, "
                      f"JAX {ref_its}")
            del r
            torch.cuda.empty_cache()
    for k, least in ((0, 1.8), (1, 2.8)):
        order = math.log2(err[(256, k)] / err[(512, k)])
        line("polymesh_order", k=k, l2_256_512=order, least=least)
        check(order >= least, f"bricks k={k}: L2 order {order} < {least}")


def _peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def cut_preprocess_phase() -> None:
    """Phase 16: the generic cut_preprocess on every cell of the 1024^2
    mesh against the band-restricted cut_preprocess_band (the same
    classification and the same moved points), the agglomeration
    detection branch and make_neighbors_info at 1024^2."""
    from proton_tpu_torch.core.mesh import make_poly_mesh
    from proton_tpu_torch.cut import classify
    from proton_tpu_torch.cut.fictdom_structured import default_problem

    ls = default_problem().ls
    mesh = make_poly_mesh(Nx=1024, Ny=1024, device="cuda")
    torch.cuda.synchronize()
    times = {}
    out = {}
    for name, fn in (("generic", classify.cut_preprocess),
                     ("band", classify.cut_preprocess_band)):
        t0 = time.perf_counter()
        out[name] = fn(mesh, ls, 4)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
    (mg, cg_), (mb, cb) = out["generic"], out["band"]
    point_diff = float((mg.points - mb.points).abs().max())
    cut = cg_.cell_loc == classify.LOC_CUT
    iface_diff = float((cg_.interface[cut] - cb.interface[cut]).abs().max())
    line("cut_preprocess", N=1024, generic_s=times["generic"],
         band_s=times["band"], cut_cells=int(cut.sum()),
         distorted=int(cg_.distorted.sum()), max_abs_point_diff=point_diff,
         max_abs_interface_diff=iface_diff)
    for f in ("cell_loc", "face_loc", "node_loc", "distorted"):
        check(torch.equal(getattr(cg_, f), getattr(cb, f)),
              f"1024^2: generic and band {f} differ")
    check(point_diff == 0.0, f"1024^2: moved points differ by {point_diff}")
    del out, mg, mb, cg_, cb

    t0 = time.perf_counter()
    ma, ca = classify.cut_preprocess(mesh, ls, 4, agglomeration=True)
    torch.cuda.synchronize()
    agglo_s = time.perf_counter() - t0
    counts = torch.bincount(ca.agglo_set.to(torch.int64), minlength=4)
    t0 = time.perf_counter()
    nbrs = classify.make_neighbors_info(mesh)
    nbr_s = time.perf_counter() - t0
    line("cut_preprocess_agglomeration", N=1024, seconds=agglo_s,
         agglo_undef=int(counts[0]), agglo_ok=int(counts[1]),
         agglo_ko_neg=int(counts[2]), agglo_ko_pos=int(counts[3]),
         neighbors_s=nbr_s, neighbors_shape=tuple(nbrs.shape))
    n_cut = int((ca.cell_loc == classify.LOC_CUT).sum())
    check(int(counts[1:].sum()) == n_cut,
          "every cut cell must get an agglo set, and no other cell")
    check(bool(torch.equal(ma.points, mesh.points)),
          "the agglomeration branch must not move nodes")
    # interior cells have 8 point neighbours, corner cells 3
    per_cell = (nbrs >= 0).sum(1)
    check(int(per_cell.max()) == 8 and int(per_cell.min()) == 3,
          "make_neighbors_info: neighbour counts")
    del ma, ca, nbrs, mesh
    torch.cuda.empty_cache()


def fictdom_generic(N: int, k: int, **kw):
    """run_fictdom(N, k) on the card with its numbers printed; checked
    converged with a finite H1 error."""
    from proton_tpu_torch.cut import fictdom
    from proton_tpu_torch.solvers import cg

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t, t0 = {}, time.perf_counter()
    r = fictdom.run_fictdom(N, k, device="cuda", timings=t, **kw)
    wall = time.perf_counter() - t0
    line("fictdom_generic", N=N, k=k, exit=r.exit_reason,
         iterations=r.iterations, h1=r.h1_error,
         ms_per_iteration=1e3 * t["cg_s"] / max(r.iterations, 1),
         wall_s=wall, peak_gb=_peak_gb(),
         **span_summary(t))
    check(r.exit_reason == cg.CONVERGED, f"fictdom {N}^2 k={k}: exit "
          f"{r.exit_reason}")
    check(math.isfinite(r.h1_error), f"fictdom {N}^2 k={k}: H1")
    return r


def fictdom_generic_phase() -> None:
    """Phase 17: the generic fictitious-domain solve (Jacobi PCG on the
    full cell + face system, tol 1e-12): the JAX gates at 16^2, 32^2 k=1
    and 16^2 k=2, then 64^2 ... 256^2 k=1 with the H1 order from 128^2
    (512^2, 21 s of Jacobi PCG, was cut to fit phases 23-24 in the
    budget), and at 256^2 against the structured solve of the same
    problem (the same discretization: on the CPU at 32^2 the two JAX
    paths agree to 1.7e-9 relative in H1)."""
    from proton_tpu_torch.cut import fictdom_structured as fs
    from proton_tpu_torch.solvers import cg

    for (n, k), (ref_its, ref_h1) in FICTDOM_GATES.items():
        r = fictdom_generic(n, k)
        slack = 2 if k < 2 else FICTDOM_K2_ITERATIONS * ref_its
        line("fictdom_gate", N=n, k=k, iterations=r.iterations,
             ref_iterations=ref_its, h1=r.h1_error, ref_h1=ref_h1)
        check(abs(r.iterations - ref_its) <= slack,
              f"fictdom {n}^2 k={k}: iterations")
        check(math.isclose(r.h1_error, ref_h1,
                           rel_tol=1e-6 if k < 2 else 1e-4),
              f"fictdom {n}^2 k={k}: H1")
    h1 = {}
    for n in (64, 128, 256):
        h1[n] = fictdom_generic(n, 1).h1_error
    order = math.log2(h1[128] / h1[256])
    line("fictdom_generic_order", h1_128=h1[128], h1_256=h1[256],
         order=order)
    check(1.8 <= order <= 2.2, f"fictdom H1 order {order} outside "
          "[1.8, 2.2]")
    params = cg.CGParams(convergence_threshold=1e-12,
                         divergence_threshold=1e8, max_iter=200000,
                         apply_preconditioner=True)
    t0 = time.perf_counter()
    s = fs.solve_fictdom_structured(256, 1, fitted="full",
                                    precond="block_jacobi",
                                    cg_params=params, device="cuda")
    line("fictdom_generic_vs_structured", N=256, h1_generic=h1[256],
         h1_structured=s.h1_error, iterations_structured=s.iterations,
         rel=abs(h1[256] - s.h1_error) / s.h1_error,
         seconds_structured=time.perf_counter() - t0)
    check(math.isclose(h1[256], s.h1_error, rel_tol=1e-6),
          "256^2: generic and structured fictdom H1 differ")
    del s
    torch.cuda.empty_cache()


def interface_solve(N: int, k: int, **kw):
    """run_interface(N, k) on the card with its numbers printed; checked
    converged with a finite H1 error."""
    from proton_tpu_torch.cut import interface_problem as ip
    from proton_tpu_torch.solvers import cg

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t, t0 = {}, time.perf_counter()
    r = ip.run_interface(N, k, device="cuda", timings=t, **kw)
    wall = time.perf_counter() - t0
    line("interface", N=N, k=k, exit=r.exit_reason,
         iterations=r.iterations, h1=r.h1_error,
         ms_per_iteration=1e3 * t["cg_s"] / max(r.iterations, 1),
         wall_s=wall, peak_gb=_peak_gb(),
         **{key: v for key, v in kw.items() if key != "parms"},
         **span_summary(t))
    check(r.exit_reason == cg.CONVERGED, f"interface {N}^2 k={k}: exit "
          f"{r.exit_reason}")
    check(math.isfinite(r.h1_error), f"interface {N}^2 k={k}: H1")
    return r


def profile_interface(N: int, k: int, iterations: int) -> None:
    """torch.profiler over `iterations` PCG iterations of the condensed
    N^2 interface system under its MG preconditioner: ms per iteration,
    kernel launches per iteration, the device's busy share, and the
    scalar reads (one: the exit test) and host-to-device copies (none)
    per iteration."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from proton_tpu_torch.core.mesh import make_poly_mesh
    from proton_tpu_torch.core.ops import HHODegreeInfo
    from proton_tpu_torch.cut import classify, interface_problem as ip
    from proton_tpu_torch.cut.fictdom_structured import default_problem
    from proton_tpu_torch.solvers import cg

    p, hdi, parms = default_problem(), HHODegreeInfo(k + 1, k), \
        ip.InterfaceParams()
    mesh, cd = classify.cut_preprocess(
        make_poly_mesh(Nx=N, Ny=N, device="cuda"), p.ls, 4)
    asm = ip.assemble_interface(mesh, cd, p.ls, hdi, p.rhs_fun, p.sol_fun,
                                parms)
    fsys = ip.condensed_face_system(mesh, asm, hdi, parms)
    check(fsys.preconditioner == "mg", "the interface MG branch")

    def run(n):
        # tol 0 never converges: exactly n iterations, exit 2
        return cg.conjugated_gradient(fsys.apply, fsys.rhs, None,
                                      cg.CGParams(0.0, 1e8, n - 2, True),
                                      precond=fsys.precond)

    run(3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run(iterations)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(res.iterations == iterations, "profile window length")
    events = prof.key_averages()
    reads, h2d = host_traffic(events, iterations)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    line("profile_interface", N=N, k=k, iterations=iterations,
         ms_per_iteration=1e3 * wall / iterations,
         scalar_reads_per_iteration=reads, host_to_device_copies=h2d,
         kernel_launches_per_iteration=sum(e.count for e in kernels) /
         iterations,
         device_us_per_iteration=device_us / iterations,
         device_busy_share=device_us / 1e6 / wall)
    check(reads <= 1.0, f"{reads} scalar reads per interface iteration")
    check(h2d == 0, f"{h2d} host-to-device copies in the interface window")
    del asm, fsys, mesh, cd
    torch.cuda.empty_cache()


def interface_phase() -> None:
    """Phase 18: the interface problem (condensed, uniform MG + cut-band
    Schwarz, tol 1e-9): the JAX gates, condensed against the full system,
    a kappa contrast on the block-Jacobi branch, then 256^2 and 512^2 k=1
    with the H1 order from 256^2, and the host traffic of its CG loop."""
    from proton_tpu_torch.cut import interface_problem as ip

    for (n, k), (ref_its, ref_h1) in INTERFACE_GATES.items():
        r = interface_solve(n, k)
        line("interface_gate", N=n, k=k, iterations=r.iterations,
             ref_iterations=ref_its, h1=r.h1_error, ref_h1=ref_h1)
        check(abs(r.iterations - ref_its) <= 2,
              f"interface {n}^2 k={k}: iterations")
        check(math.isclose(r.h1_error, ref_h1,
                           rel_tol=1e-6 if k < 2 else 1e-4),
              f"interface {n}^2 k={k}: H1")
        if (n, k) == (16, 1):
            cond = r
    full = interface_solve(16, 1, condensed=False)
    diff = float((full.x - cond.x).abs().max())
    xmax = float(cond.x.abs().max())
    line("interface_full_vs_condensed", N=16, k=1,
         iterations_full=full.iterations, max_abs_diff=diff,
         max_abs_x=xmax)
    check(diff <= 1e-7 * xmax, f"16^2: full and condensed x differ by {diff}")
    contrast = interface_solve(64, 1, parms=ip.InterfaceParams(1.0, 3.0))
    line("interface_contrast", N=64, kappa_1=1.0, kappa_2=3.0,
         h1=contrast.h1_error, iterations=contrast.iterations)
    h1 = {}
    for n in (256, 512):
        h1[n] = interface_solve(n, 1).h1_error
    order = math.log2(h1[256] / h1[512])
    line("interface_order", h1_256=h1[256], h1_512=h1[512],
         order_256_512=order)
    check(1.8 <= order <= 2.2, f"interface H1 order {order} outside "
          "[1.8, 2.2]")
    profile_interface(512, 1, iterations=10)


def agglomerate_phase() -> None:
    """Phase 19: agglomerate at 128^2 and 256^2 (merge and host rebuild
    timed), plain classification of the merged mesh and the generic
    fictdom solve on it: no KO cell left, the area conserved, the H1
    order above 1.6."""
    from proton_tpu_torch.core.geometry import cell_geometry
    from proton_tpu_torch.core.mesh import make_poly_mesh
    from proton_tpu_torch.cut import agglomerate as agg, classify, fictdom
    from proton_tpu_torch.cut.fictdom_structured import default_problem
    from proton_tpu_torch.solvers import cg

    p = default_problem()
    h1 = {}
    for n in (128, 256):
        mesh = make_poly_mesh(Nx=n, Ny=n, device="cuda")
        ta, t0 = {}, time.perf_counter()
        merged, groups = agg.agglomerate(mesh, p.ls, timings=ta)
        torch.cuda.synchronize()
        agg_s = time.perf_counter() - t0
        neg, pos, loc, *_ = agg._side_measures(merged, p.ls)
        meas = cell_geometry(merged).meas
        area = float(meas.sum())
        meas = meas.cpu().numpy()
        cut = loc == classify.LOC_CUT
        frac = float((np.minimum(neg, pos)[cut] / meas[cut]).min())
        t0 = time.perf_counter()
        m3, cd = classify.cut_preprocess(merged, p.ls, 4,
                                         displacement=False)
        torch.cuda.synchronize()
        classify_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t = {}
        r = fictdom.solve_fictdom(m3, cd, p.ls, 1, p.rhs_fun, p.sol_fun,
                                  p.sol_grad, timings=t)
        h1[n] = r.h1_error
        line("agglomerate", N=n, cells=merged.num_cells, merges=groups,
             max_pts=merged.max_pts, area=area, min_side_fraction=frac,
             agglomerate_s=agg_s,
             **{f"agglomerate_{key}": round(v, 4) for key, v in ta.items()},
             classify_s=classify_s, iterations=r.iterations,
             h1=r.h1_error, exit=r.exit_reason,
             ms_per_iteration=1e3 * t["cg_s"] / max(r.iterations, 1),
             peak_gb=_peak_gb(), **span_summary(t))
        check(merged.num_cells == n * n - groups and merged.max_pts > 4,
              f"agglomerate {n}^2: cell count")
        check(abs(area - 1.0) < 1e-12, f"agglomerate {n}^2: area {area}")
        check(frac > 0.09, f"agglomerate {n}^2: a KO cell is left "
              f"(side fraction {frac})")
        check(r.exit_reason == cg.CONVERGED and math.isfinite(r.h1_error),
              f"agglomerate {n}^2: fictdom solve")
        del mesh, merged, m3, cd, r
        torch.cuda.empty_cache()
    order = math.log2(h1[128] / h1[256])
    line("agglomerate_order", h1_128=h1[128], h1_256=h1[256], order=order)
    check(order > 1.6, f"agglomerated fictdom H1 order {order} <= 1.6")


def cuthho_square_phase() -> None:
    """Phase 20: the cuthho_square app on the card at the BASELINE
    configuration (-f -i, 64^2, k=1) against the JAX app's errors, then
    -A -f -d at 16^2 in a temporary directory (mesh info, point clouds;
    without matplotlib the plots are skipped, as in the JAX app)."""
    import contextlib
    import io
    import os
    import tempfile

    from proton_tpu_torch.apps import cuthho_square

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cuthho_square.main(["-f", "-i", "-M", "64", "-N", "64",
                                 "-k", "1"])
    seconds = time.perf_counter() - t0
    print(buf.getvalue(), end="", flush=True)
    errors = [float(ln.split()[-1]) for ln in buf.getvalue().splitlines()
              if "Energy-norm absolute error" in ln]
    check(rc == 0 and len(errors) == 2, "cuthho_square -f -i: output")
    got = dict(zip(("interface", "fictdom"), errors))
    line("cuthho_square", N=64, k=1, seconds=seconds,
         **{f"h1_{key}": v for key, v in got.items()},
         **{f"ref_{key}": v for key, v in APP_GATES_64.items()})
    for key, ref in APP_GATES_64.items():
        check(math.isclose(got[key], ref, rel_tol=1e-6),
              f"cuthho_square 64^2 -{key[0]}: H1 {got[key]}, JAX {ref}")

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            rc = cuthho_square.main(["-A", "-f", "-d", "-M", "16", "-N",
                                     "16", "-k", "1"])
            files = sorted(os.listdir(tmp))
        finally:
            os.chdir(cwd)
    line("cuthho_square_debug", N=16, files=",".join(files))
    check(rc == 0 and {"cuthho_meshinfo.vtk", "cuthho_meshinfo.npz",
                       "fictdom_uT.dat", "fictdom_Ru.dat",
                       "fictdom_diff.dat"} <= set(files),
          "cuthho_square -A -f -d: files")


# Phase 21: the geometry families (cut/batched.py). The 1024^2 family: the
# reference's centred circle (a second one, moved along the app's jitter
# circle to (0.52, 0.5), was cut for phase 26's budget: 13,548 Jacobi
# iterations; the 256^2 family and the app run several geometries).
FAMILY_RADII = (0.35,)
FAMILY_CENTERS = ((0.5, 0.5),)
FAMILY_PHASES = ("classify_s", "fitted_s", "cut_s", "condense_s", "cg_s",
                 "recover_s", "h1_s")


def family_solve(N: int, radii, centers, tol: float, device: str = "cuda"):
    """solve_fictdom_family(N, 1) with K1's launch count and the cell
    counts of those launches set to 0 just before and read just after;
    its numbers printed: iterations, ms per iteration, seconds per
    geometry by phase, peak memory. Checked: all converged, no overflow,
    no bad cut, no concave cell, finite H1 errors, one K1 launch per
    geometry on all N^2 cells. Returns (result, launches)."""
    from proton_tpu_torch.cut import batched
    from proton_tpu_torch.methods import fused_assembly as fa
    from proton_tpu_torch.solvers import cg

    B = len(radii)
    params = cg.CGParams(convergence_threshold=tol, divergence_threshold=1e8,
                         max_iter=50000, apply_preconditioner=True)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    timings = {}
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    res = batched.solve_fictdom_family(N, 1, radii, centers,
                                       cg_params=params, device=device,
                                       timings=timings)
    wall = time.perf_counter() - t0
    launches = fa.fused_local_operator.launches
    cells = list(fa.fused_local_operator.launch_cells)
    iterations = res.iterations.tolist()
    line("family", N=N, k=1, B=B, tol=tol, wall_s=wall,
         per_geometry_s=wall / B, iterations=",".join(map(str, iterations)),
         h1=",".join(map(repr, res.h1_error.tolist())),
         n_cut=",".join(map(str, res.n_cut.tolist())),
         ms_per_iteration=1e3 * timings["cg_s"] / max(sum(iterations), 1),
         kernel="fused_local_operator", launches=launches,
         launch_cells=",".join(map(str, cells)),
         peak_gb=_peak_gb() if on_card else None,
         **{f"{key}_per_geometry": round(timings[key] / B, 4)
            for key in FAMILY_PHASES})
    check(res.exit_reason.tolist() == [cg.CONVERGED] * B,
          f"family {N}^2: exits {res.exit_reason.tolist()}")
    check(res.n_cut_overflow.tolist() == [0] * B and
          res.n_bad_cuts.tolist() == [0] * B and
          not bool(res.concave.any()),
          f"family {N}^2: overflow, bad cuts or concave cells")
    check(bool(torch.isfinite(res.h1_error).all()), f"family {N}^2: H1")
    if on_card:
        check(launches == B and cells == [N * N] * B,
              f"family {N}^2: K1 launched {launches} times at {cells}")
    return res, launches


def family_app(args, device: str = "cuda") -> dict:
    """apps/fictdom_family.py with ``args``: its JSON line, printed and
    checked (all converged, no overflow)."""
    import contextlib
    import io

    from proton_tpu_torch.apps import fictdom_family

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fictdom_family.main([*args, "--device", device])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    line("family_app", args=" ".join(args), total_s=out["total_s"],
         per_geometry_s=out["per_geometry_s"],
         iterations_min=min(out["iterations"]),
         iterations_max=max(out["iterations"]),
         n_cut_max=max(out["n_cut"]), all_converged=out["all_converged"],
         overflow=out["overflow"], backend=out["backend"])
    check(rc == 0 and out["all_converged"] and out["overflow"] == 0,
          f"fictdom_family {' '.join(args)}: {out}")
    return out


def family_phase(bw: float, flop_peak: float, N: int = 1024,
                 N_app: int = 256, N_pair: int = 128, device: str = "cuda"):
    """Phase 21: K1 against its plain version on the displaced N^2 mesh of
    one family geometry; the N^2 k=1 family (FAMILY_RADII) at the app's tol
    1e-6 with K1's launches; the app at its documented widths with 8 of
    its 64 geometries (-N 256 -k 1 -B 8); the ellipse and flower
    families at 256^2 B=2;
    and two geometries at N_pair^2, tol 1e-10, each equal to the structured
    solve of the same circle (H1 rtol 1e-8). The structured solve is
    fitted="full" with precond="jacobi", the same discrete system (K1 on
    every cell), so only rounding separates the two. Returns K1's record
    row at the family's shape, the family's launches and the app's line
    at -B 8 (phase 27 prints the float32 app beside it)."""
    from proton_tpu_torch.core.geometry import cell_geometry
    from proton_tpu_torch.core.mesh import make_poly_mesh
    from proton_tpu_torch.cut import fictdom_structured as fs
    from proton_tpu_torch.cut.classify import LOC_CUT, _preprocess_core
    from proton_tpu_torch.methods import fused_assembly as fa
    from proton_tpu_torch.solvers import cg

    p = fs.default_problem(FAMILY_RADII[0], FAMILY_CENTERS[0])
    mesh = make_poly_mesh(Nx=N, Ny=N, device=device)
    pts, cutdata, _, _ = _preprocess_core(mesh, p.ls, 4)
    mesh2 = mesh.with_points(pts)
    line("family_mesh", N=N, displaced=int(cutdata.distorted.sum()),
         cut=int((cutdata.cell_loc == LOC_CUT).sum()))
    row = kernel_row(fa.pack_inputs(mesh2, cell_geometry(mesh2)), 2, 1,
                     1e-11, bw, flop_peak)
    del mesh, mesh2, pts, cutdata

    _, launches = family_solve(N, FAMILY_RADII, FAMILY_CENTERS, 1e-6,
                               device)
    app = family_app(["-N", str(N_app), "-k", "1", "-B", "8"], device)
    for shape in ("ellipse", "flower"):
        family_app(["-N", str(N_app), "-k", "1", "-B", "2", "--shape",
                    shape], device)

    radii, centers = (0.3, 0.41), ((0.5, 0.5), (0.48, 0.52))
    fam, _ = family_solve(N_pair, radii, centers, 1e-10, device)
    params = cg.CGParams(convergence_threshold=1e-10,
                         divergence_threshold=1e8, max_iter=50000,
                         apply_preconditioner=True)
    for b, (radius, center) in enumerate(zip(radii, centers)):
        s = fs.solve_fictdom_structured(
            N_pair, 1, fs.default_problem(radius, center), fitted="full",
            precond="jacobi", cg_params=params, device=device)
        rel = abs(float(fam.h1_error[b]) - s.h1_error) / s.h1_error
        line("family_vs_structured", N=N_pair, radius=radius,
             center=f"{center[0]},{center[1]}",
             h1_family=float(fam.h1_error[b]), h1_structured=s.h1_error,
             rel=rel, iterations_family=int(fam.iterations[b]),
             iterations_structured=s.iterations)
        check(s.exit_reason == cg.CONVERGED and rel < 1e-8,
              f"family {N_pair}^2 geometry {b}: H1 {rel} apart from the "
              "structured solve")
    return row, launches, app


def options_phase(N: int = 256, N_smoother: int = 64,
                  N_classify: int = 1024, device: str = "cuda") -> dict:
    """Phase 22: the options of solve_fictdom_structured beyond the
    default path, k=1, tol 1e-11: fitted="uniform" equal to fitted="lean" at N^2
    (the same iterations, local dofs to 1e-12); the damped block-Jacobi
    and Jacobi smoothers at N_smoother^2 (local dofs within 2e-8 of the
    Chebyshev solve; their counts grow too fast to run them at 256^2 here:
    12,955 and 21,817 iterations there against Chebyshev's 105); and
    classify_level(method="full") equal to the band one at N_classify^2
    (codes, moved points, cut cells). Returns {n: the lean n^2 solve} at N
    and 128 (phase 27 holds options against them)."""
    from proton_tpu_torch.cut import fictdom_structured as fs

    mg = dict(fitted="lean", precond="mg", device=device)
    lean = solve(N, 1, 1e-11, **mg)
    uni = solve(N, 1, 1e-11, **dict(mg, fitted="uniform"))
    diff = float((uni.local - lean.local).abs().max())
    line("options_uniform", N=N, iterations_uniform=uni.iterations,
         iterations_lean=lean.iterations, max_abs_local_diff=diff)
    check(uni.iterations == lean.iterations and diff <= 1e-12,
          f"{N}^2: fitted='uniform' differs from 'lean' by {diff}")
    cheb = solve(N_smoother, 1, 1e-11, **mg)
    for smoother in ("block_jacobi", "jacobi"):
        r = solve(N_smoother, 1, 1e-11, mg_smoother=smoother, **mg)
        diff = float((r.local - cheb.local).abs().max())
        line("options_smoother", N=N_smoother, smoother=smoother,
             iterations=r.iterations, iterations_chebyshev=cheb.iterations,
             cg_s=r.timings["cg_s"], cg_s_chebyshev=cheb.timings["cg_s"],
             max_abs_local_diff=diff)
        check(diff < 2e-8, f"{N_smoother}^2: mg_smoother={smoother!r} local "
              f"dofs differ by {diff} from the Chebyshev solve")

    p = fs.default_problem()
    out, times = {}, {}
    for method in ("band", "full"):
        t0 = time.perf_counter()
        out[method] = fs.classify_level(N_classify, p, 4, device=device,
                                        method=method)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        times[method] = time.perf_counter() - t0
    (mb, cb, ib), (mf, cf, if_) = out["band"], out["full"]
    line("options_classify", N=N_classify, band_s=times["band"],
         full_s=times["full"], cut_cells=len(ib),
         max_abs_point_diff=float((mb.points - mf.points).abs().max()))
    for f in ("cell_loc", "face_loc", "node_loc", "distorted"):
        check(torch.equal(getattr(cb, f), getattr(cf, f)),
              f"{N_classify}^2: classify_level band and full {f} differ")
    check(torch.equal(mb.points, mf.points) and np.array_equal(ib, if_),
          f"{N_classify}^2: classify_level band and full points or cut "
          "cells differ")
    return {N: lean, 128: solve(128, 1, 1e-11, **mg)}


# Phase 23: the Galerkin coarse hierarchy. The JAX package on the CPU in
# float64, (iterations, H1) of solve_fictdom_structured(N, k,
# mg_galerkin=True, mg_gamma=gamma, mixed=False, use_pallas=False) at CG
# tol 1e-11, divergence 1e8, max_iter 50000 (tests/test_torch_galerkin.py
# holds the port to the same numbers on the CPU): (N, k, gamma) ->
GALERKIN_GATES = {(16, 1, 1): (11, 0.004434838976281151),
                  (32, 1, 1): (19, 0.0011344765335767838),
                  (16, 2, 1): (9, 0.0001804137275041844),
                  (32, 1, 2): (22, 0.0011344765320524402)}


def galerkin_levels(N: int, k: int, levels=None, device: str = "cuda"):
    """{n: GalerkinLevel} of fs.band_galerkin_levels on ``levels`` (by
    default the lean N^2 levels, built here), with its host seconds and
    its deviation pairs, patch cells and stencil width per level
    printed."""
    from proton_tpu_torch.core.ops import HHODegreeInfo
    from proton_tpu_torch.cut import fictdom_structured as fs

    hdi = HHODegreeInfo(k + 1, k)
    if levels is None:
        problem, eta = fs.default_problem(), fs.nitsche_eta(k)
        levels = {N: fs.build_level(N, hdi, problem, eta, 4, device=device,
                                    fitted="lean"),
                  **fs.build_coarse_levels(N, hdi, problem, eta, 4,
                                           device=device)}
    t0 = time.perf_counter()
    gal = fs.band_galerkin_levels(levels, hdi)
    torch.cuda.synchronize()
    line("galerkin_levels", N=N, k=k, seconds=time.perf_counter() - t0,
         **{f"pairs_{n}": int(g.rows.shape[0]) for n, g in gal.items()},
         **{f"patch_cells_{n}": int(g.cells.shape[0])
            for n, g in gal.items()},
         **{f"stencil_{n}": g.kernel.shape[-1] for n, g in gal.items()})
    return gal


def galerkin_solve(tag: str, N: int, k: int, cap: Optional[int] = None):
    """counted_solve of the lean + Galerkin multigrid solve at tol 1e-11
    (``cap``: solve()'s): (result, K1 launches, their cell counts). The
    unit-cell operators are computed anew, so K1's launches are the lean
    path's whatever ran before."""
    from proton_tpu_torch.cut import fictdom_structured as fs

    fs._unit_cell_host.cache_clear()
    r, launches, cells = counted_solve(
        tag, N, k, 1e-11, fitted="lean", precond="mg", mg_galerkin=True,
        cap=cap)
    line("galerkin_setup", N=N, k=k,
         galerkin_setup_s=r.timings["galerkin_setup_s"])
    return r, launches, cells


# Phase 23: the H1 gap between the Galerkin and the rediscretized solve at
# 1024^2 k=2, tol 1e-11: 1.38e-4 to 1.55e-4 in four runs on the H100
# (PERF.md §5). Below 1024^2 the gap is 5.4e-5 or less and the gate 1e-4.
GALERKIN_H1_RTOL_1024 = 5e-4


def against_rediscretized(N: int, k: int, gal, red) -> None:
    """The Galerkin solve against the rediscretized one of the same N, k
    and tol 1e-11: local dofs within 1e-6 of max|local|, H1 within rtol
    1e-4 below 1024^2 and GALERKIN_H1_RTOL_1024 at 1024^2, where each
    solve's algebraic error at tol 1e-11 moves the H1 error by about
    1.5e-4."""
    diff = float((gal.local - red.local).abs().max())
    umax = float(red.local.abs().max())
    h1_rtol = GALERKIN_H1_RTOL_1024 if N >= 1024 else 1e-4
    line("galerkin_vs_rediscretized", N=N, k=k,
         iterations_galerkin=gal.iterations,
         iterations_rediscretized=red.iterations,
         ms_per_iteration_galerkin=1e3 * gal.timings["cg_s"] /
         gal.iterations,
         ms_per_iteration_rediscretized=1e3 * red.timings["cg_s"] /
         red.iterations,
         h1_galerkin=gal.h1_error, h1_rediscretized=red.h1_error,
         h1_rel=abs(gal.h1_error - red.h1_error) / red.h1_error,
         max_abs_local_diff=diff, max_abs_local=umax)
    check(math.isclose(gal.h1_error, red.h1_error, rel_tol=h1_rtol),
          f"{N}^2 k={k}: Galerkin H1 {gal.h1_error} against "
          f"{red.h1_error}")
    check(diff <= 1e-6 * umax, f"{N}^2 k={k}: Galerkin local dofs "
          f"{diff} from the rediscretized solve's")


# Phase 23: the 1024^2 k=1 Galerkin solve stalls: its relative residual
# stays near 1e-4 from 300 to 1,600 iterations, and 512^2 k=1 does not
# reach 1e-11 in 1,600 (proton_tpu_torch/tools/galerkin_history.py on the
# H100; PERF.md). The JAX package stalls alike: its float64 Galerkin solve
# takes the port's counts at 128^2 and 256^2 k=1 on the CPU. So it runs
# capped at GALERKIN_K1_CAP iterations, is not held against phase 7's
# solution, and must reach GALERKIN_K1_REL there (1.19e-4 to 1.34e-4 in
# four runs on the H100): a worse hierarchy shows.
GALERKIN_K1_CAP = 300
GALERKIN_K1_REL = 3e-4


def galerkin_phase(red, displaced_cells):
    """Phase 23 [galerkin], tol 1e-11, float64: the JAX package's gates at
    16^2, 32^2 k=1 (also with mg_gamma=2) and 16^2 k=2 (iterations within
    2, H1 rtol 1e-6 at k=1, 1e-4 at k=2); k=2 at 256^2 with
    mg_galerkin=True, held against the rediscretized solve of the same N,
    k and tol in ``red`` (phase 9; against_rediscretized), with K1's
    launches and cell counts
    (mg_gamma=2 runs in the 32^2 gate only: at 256^2 and 512^2 k=2 it
    takes 307 and 957 iterations at 145-180 ms, 45 and 170 s, more than
    the budget leaves; tools/galerkin_history.py --gamma 2 measures it);
    torch.profiler over 20 Galerkin-MG
    iterations at 256^2 k=2 on a hierarchy built anew from the
    profiled levels; the 1024^2 k=1 solve capped at GALERKIN_K1_CAP
    iterations (it stalls), its residual below GALERKIN_K1_REL, with K1's
    launches. Returns K1's launches in the 1024^2 k=1
    and the 256^2 k=2 Galerkin solves."""
    for (n, k, gamma), (iters, h1) in GALERKIN_GATES.items():
        r = solve(n, k, 1e-11, fitted="lean", precond="mg", mg_galerkin=True,
                  mg_gamma=gamma)
        line("galerkin_gate", N=n, k=k, gamma=gamma, iterations=r.iterations,
             ref_iterations=iters, h1=r.h1_error, ref_h1=h1)
        check(abs(r.iterations - iters) <= 2,
              f"{n}^2 k={k} gamma={gamma}: Galerkin iterations")
        check(math.isclose(r.h1_error, h1, rel_tol=1e-6 if k == 1 else 1e-4),
              f"{n}^2 k={k} gamma={gamma}: Galerkin H1")
    galerkin_levels(256, 2)
    torch.cuda.empty_cache()
    r, launches_k2, cells = galerkin_solve("galerkin_solve_256_k2", 256, 2)
    check(launches_k2 > 0 and 1 in cells,
          f"256^2 k=2: the Galerkin solve launched K1 at {cells}")
    against_rediscretized(256, 2, r, red[(256, 2)])
    del r
    torch.cuda.empty_cache()
    profile_mg(256, 2, iterations=20, galerkin=True, tag="profile_galerkin")
    torch.cuda.empty_cache()

    r, launches_k1, cells = galerkin_solve(
        "galerkin_solve_1024_k1", 1024, 1, cap=GALERKIN_K1_CAP)
    check_lean_launches("the Galerkin 1024^2 k=1 solve", cells,
                        displaced_cells)
    line("galerkin_stall", N=1024, k=1, iterations=r.iterations,
         exit=r.exit_reason, rel=r.rel_residual, rel_limit=GALERKIN_K1_REL,
         iterations_rediscretized=red[(1024, 1)].iterations)
    check(r.rel_residual < GALERKIN_K1_REL,
          f"1024^2 k=1: the Galerkin residual {r.rel_residual} after "
          f"{r.iterations} iterations, above {GALERKIN_K1_REL}")
    del r
    torch.cuda.empty_cache()
    return launches_k1, launches_k2


# Phase 24: the condensed uncut system's Jacobi PCG runs into the rounding
# floor between 1e-11 and 1e-12 (512^2 k=1 on the H100: 803 and 805
# iterations at 1e-12 for two summation orders of one operator; on the
# CPU 18 / 414 / 760 iterations at 1e-10 / 1e-11 / 1e-12), so the halo
# solve is held to the single-process one at 1e-10.
HALO_TOL = 1e-10


def parallel_phase(N: int = 512, k: int = 1, tol: float = 1e-12,
                   device: str = "cuda") -> None:
    """Phase 24 [parallel]: proton_tpu_torch.parallel on one card, a
    process group of world size 1 on NCCL over CUDA tensors (file://
    store in a temporary directory, destroyed at the end). On the uncut
    N^2 k=1 problem: sharded_solve against the single-process Jacobi PCG
    of the same global system at tol (equal iterations, x within 1e-9),
    solve_condensed_halo against solve_condensed_structured at HALO_TOL
    (equal iterations, local dofs within 1e-9) and at tol (local dofs
    within 1e-9; the counts are printed), halo_diagonal against
    structured_diagonal; ms per iteration of each. Exchanges between ranks
    are held only by the CPU tests (tests/test_torch_parallel.py: gloo, 2
    and 4 ranks): with one card, multi-rank NCCL is not measured."""
    import tempfile

    import torch.distributed as dist

    from proton_tpu_torch.core.geometry import cell_geometry
    from proton_tpu_torch.core.mesh import make_quad_mesh
    from proton_tpu_torch.core.ops import HHODegreeInfo, cell_rhs
    from proton_tpu_torch.methods import assembly, condensation, poisson, \
        structured
    from proton_tpu_torch.parallel import halo, sharding
    from proton_tpu_torch.solvers import cg

    rhs_fn, sol, _ = _sin_problem()
    hdi = HHODegreeInfo(k + 1, k)
    params, halo_params = (cg.CGParams(
        convergence_threshold=t, divergence_threshold=1e8, max_iter=200000,
        apply_preconditioner=True) for t in (tol, HALO_TOL))
    on_card = torch.device(device).type == "cuda"
    backend = "nccl" if on_card else "gloo"
    mesh = make_quad_mesh(Nx=N, Ny=N, device=device)
    geom = cell_geometry(mesh)
    lc = poisson.assemble_local(mesh, geom, hdi)[1]
    f = cell_rhs(mesh, geom, hdi.cell_degree, rhs_fn)
    dm = assembly.build_dofmap(mesh, hdi)
    g_loc = assembly.local_dirichlet_data(
        dm, mesh, assembly.dirichlet_face_data(mesh, hdi, sol))
    rhs = assembly.assemble_rhs(dm, f, lc, g_loc)

    def timed_call(fn):
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        dmesh = sharding.make_device_mesh(
            device, init_method=f"file://{tmp}/store",
            rank=0, world_size=1)
        try:
            line("parallel", backend=dist.get_backend(), world_size=1,
                 device=str(dmesh.device))
            check(dist.get_backend() == backend,
                  f"the group is not on {backend}")
            single, t_single = timed_call(lambda: cg.conjugated_gradient(
                assembly.make_operator(dm, lc), rhs,
                assembly.operator_diagonal(dm, lc), params))
            dm_pad, C = sharding.build_dofmap_padded(mesh, hdi, 1)
            sharded, t_sharded = timed_call(lambda: sharding.sharded_solve(
                dmesh, dm_pad, lc, rhs, params))
            diff = float((sharded.x - single.x).abs().max())
            line("parallel_sharded", N=N, k=k, tol=tol,
                 iterations=sharded.iterations,
                 iterations_single=single.iterations,
                 ms_per_iteration=1e3 * t_sharded / sharded.iterations,
                 ms_per_iteration_single=1e3 * t_single / single.iterations,
                 max_abs_x_diff=diff)
            check(sharded.exit_reason == cg.CONVERGED and
                  sharded.iterations == single.iterations and diff <= 1e-9,
                  f"{N}^2: sharded_solve differs from the single-process "
                  f"solve ({sharded.iterations} against {single.iterations} "
                  f"iterations, x {diff})")
            del single, sharded

            sys_ = structured.make_structured_system(N, N, dm.fbs,
                                                     device=device)
            cond = condensation.condense(lc, f, dm.cbs)
            for p in (halo_params, params):
                (local_ref, ref), t_ref = timed_call(
                    lambda: structured.solve_condensed_structured(
                        sys_, lc, f, dm.cbs, g_loc, p))
                (local, res), t_halo = timed_call(
                    lambda: halo.solve_condensed_halo(
                        dmesh, sys_, cond, g_loc, dm.cbs, p))
                diff = float((local - local_ref).abs().max())
                line("parallel_halo", N=N, k=k,
                     tol=p.convergence_threshold, iterations=res.iterations,
                     iterations_single=ref.iterations,
                     ms_per_iteration=1e3 * t_halo / res.iterations,
                     ms_per_iteration_single=1e3 * t_ref / ref.iterations,
                     max_abs_local_diff=diff)
                check(res.exit_reason == cg.CONVERGED and diff <= 1e-9,
                      f"{N}^2 tol {p.convergence_threshold}: "
                      f"solve_condensed_halo local dofs {diff} from "
                      "solve_condensed_structured's")
                check(p is params or res.iterations == ref.iterations,
                      f"{N}^2: solve_condensed_halo took {res.iterations} "
                      f"iterations, solve_condensed_structured "
                      f"{ref.iterations}")
            d = halo.halo_diagonal(dmesh, sys_, cond.S)
            d_ref = structured.structured_diagonal(sys_, cond.S)
            d_diff = max(float((d.H - d_ref.H[:-1]).abs().max()),
                         float((d.V - d_ref.V).abs().max()))
            line("parallel_halo_diagonal", N=N, max_abs_diff=d_diff)
            check(d_diff <= 1e-12 * float(d_ref.V.abs().max()),
                  f"{N}^2: halo_diagonal differs by {d_diff}")
        finally:
            dist.destroy_process_group()
    del lc, cond
    if on_card:
        torch.cuda.empty_cache()


def bench_phase(ref, displaced_cells, N: int = 1024, N_cli: int = 128,
                device: str = "cuda"):
    """Phase 25 [bench]: proton_tpu_torch.bench.run_bench(N, 1) in this
    process at PROTON_BENCH_TOL=1e-11 (the other knobs at their
    defaults), with K1's launches and their cell counts set to 0 just
    before and read just after (the unit-cell cache emptied first, so the
    lean launches are the bench's own whatever ran before): two launches
    on all N^2 cells and the lean path's (check_lean_launches). Held to
    ``ref``, phase 7's lean + MG solve of the same system at the same tol:
    CG exit 0, iterations within 2, H1 within rtol 1e-6. Meanwhile the
    stock form of `python -m proton_tpu_torch.bench` at
    PROTON_BENCH_N=N_cli runs as a subprocess: exit 0, two JSON lines, the
    last with the k=2 fields under "k2". Every JSON line is printed on a
    [bench] line. Returns K1's launches in the run_bench call."""
    import os

    from proton_tpu_torch import bench

    knobs = [k for k in os.environ if k.startswith("PROTON_BENCH_")]
    check(not knobs, f"phase 25 runs the bench's defaults; {knobs} are set")
    cmd = [sys.executable, "-m", "proton_tpu_torch.bench"]
    if device != "cuda":
        cmd += ["--device", device]
    t0 = time.perf_counter()
    cli = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                           env=dict(os.environ, PROTON_BENCH_N=str(N_cli)),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        launches = bench_in_process(ref, displaced_cells, N, device)
        stdout, stderr = cli.communicate(timeout=600)
    finally:
        cli.kill()
    rows = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    for row in rows:
        print("[bench] " + row, flush=True)
    line("bench_cli", N=N_cli, exit=cli.returncode, lines=len(rows),
         seconds=time.perf_counter() - t0)
    check(cli.returncode == 0 and len(rows) == 2,
          f"the bench CLI at {N_cli}^2 exited {cli.returncode} with "
          f"{len(rows)} lines: {stderr[-2000:]}")
    first, last = (json.loads(r) for r in rows)
    k2 = last.pop("k2", {})
    check(first["k"] == 1 and last == first and k2.get("k") == 2 and
          k2.get("cg_exit") == 0 and
          set(bench._K2_FIELDS) <= set(k2),
          f"the bench CLI at {N_cli}^2: k2 {k2}")
    return launches


def bench_in_process(ref, displaced_cells, N: int, device: str) -> int:
    """Phase 25's run_bench(N, 1) at tol 1e-11 in this process, held to
    phase 7's solve (bench_phase). Returns K1's launches."""
    import os

    from proton_tpu_torch import bench
    from proton_tpu_torch.cut import fictdom_structured as fs
    from proton_tpu_torch.methods import fused_assembly as fa

    os.environ["PROTON_BENCH_TOL"] = "1e-11"
    try:
        fs._unit_cell_host.cache_clear()
        fa.reset_launch_counts()
        result = bench.run_bench(N, 1, device)
        launches = fa.fused_local_operator.launches
        cells = list(fa.fused_local_operator.launch_cells)
    finally:
        del os.environ["PROTON_BENCH_TOL"]
    print("[bench] " + json.dumps(result), flush=True)
    line("bench_launches", kernel="fused_local_operator", launches=launches,
         launch_cells=",".join(map(str, cells)))
    if torch.device(device).type == "cuda":
        check(cells.count(N * N) == 2,
              f"the bench launched K1 on all {N * N} cells "
              f"{cells.count(N * N)} times, not 2")
        check_lean_launches("the bench's lean system and levels",
                            [c for c in cells if c != N * N],
                            displaced_cells)
    line("bench_vs_phase7", N=N, iterations=result["cg_iters"],
         iterations_phase7=ref.iterations, h1=result["h1_error"],
         h1_phase7=ref.h1_error)
    check(result["cg_exit"] == 0, f"bench {N}^2: CG exit {result['cg_exit']}")
    check(abs(result["cg_iters"] - ref.iterations) <= 2,
          f"bench {N}^2: {result['cg_iters']} iterations, phase 7 "
          f"{ref.iterations}")
    check(math.isclose(result["h1_error"], ref.h1_error, rel_tol=1e-6),
          f"bench {N}^2: H1 {result['h1_error']}, phase 7 {ref.h1_error}")
    del result
    torch.cuda.empty_cache()
    return launches


# Phase 26: the JAX package on the CPU at 16^2, (iterations, exit code, H1
# error) of its precision modes: solve_fictdom_structured(16, k, ...,
# use_pallas=False), divergence 1e8, max_iter 50000, x64 on; the cases of
# scripts/precision_jax_gates.py (which prints them) and of
# tests/test_torch_precision.py: mixed=True, fitted="lean" at tol 1e-9,
# k=1 and 2; mixed=False, mg_f32=True at tol 1e-11, k=2.
PRECISION_GATES = {
    "mixed_k1": (1, 1e-9, dict(mixed=True), (9, 0, 0.004434721544384956)),
    "mixed_k2": (2, 1e-9, dict(mixed=True), (9, 0, 0.00018096464918926358)),
    "mg_f32_k2": (2, 1e-11, dict(mg_f32=True),
                  (12, 0, 0.00018041372739208727))}

# Phase 26: the JAX package's bound on the mixed system's H1 error at
# 16^2 k=2, its float32 noise (tests/test_fictdom_structured.py:52-69).
# It does not hold at 1024^2: the float32 system's rounding, amplified by
# the condition number (~N^2), gives H1 1.51 there on the H100 (float64:
# 1.16e-6), and its float32 noise grows alike in both packages on the CPU
# (5.3e-5 / 3.8e-4 / 2.9e-3 against 2.3e-5 / 3.5e-6 / 1.7e-6 at 32^2 /
# 64^2 / 128^2, PERF.md). It is printed beside (d)'s readings; (g) holds
# the mode to the JAX package at 16^2.
MIXED_H1_CPU_BOUND = 5e-3

# Phase 26 (d): the H1 error of the mixed 1024^2 solve at tol 1e-6, which
# is its float32 noise there, held to readings that exist (PERF.md §5;
# H100 80GB HBM3, 700 W). k=1: within a factor 2 of the JAX package's
# TPU reading in the same mode, BENCH_r04.json's 9.46e-3 (the port's
# library solve 7.28e-3, its bench 7.61e-3; float64 at that tolerance
# 9.62e-4). k=2: below twice the sound runs' largest reading (1.509, the
# mixed bench; the library solve 1.508), far below a control's,
# tools/mixed_noise.py's h1_cut_dropped (the mixed level with its cut
# class's operator dropped). (e) likewise, the float32 k=1 solve: below
# twice its sound reading, 0.415, the k=1 control far above.
BENCH_R04_MIXED_K1_H1 = 9.463188238441944e-3
SOUND_H1 = {"mixed_k2": 1.509, "f32_k1": 0.415}
CONTROL_H1 = {1: 1580870.625, 2: 4783263.5}
MIXED_H1_LIMITS = {1: (BENCH_R04_MIXED_K1_H1 / 2, BENCH_R04_MIXED_K1_H1 * 2),
                   2: (0.0, 2 * SOUND_H1["mixed_k2"])}
F32_H1_LIMIT = 2 * SOUND_H1["f32_k1"]

# Phase 26 (g): the mixed H1 error's float32 noise at 16^2 k=2 is 3.0e-3
# of it (JAX's mixed against its float64 solve); the H100's rounding lands
# 1.8e-3 from JAX's. k=1: 1.0e-3 (measured 5.2e-5).
MIXED_GATE_RTOL = {1: 1e-3, 2: 5e-3}


def f32_shape_rows(N: int, coarsest: int, bw: float, flop_peak: float):
    """K1 in float32 against its plain version at the shapes the
    precision paths give it, level by level over N, ..., coarsest: one
    cell of side 1/n and the displaced cells of the mixed classification
    (float64, rounded), at k=1 and k=2; the displaced cells of the float32
    classification at k=1 where their count differs; and every cell of
    the mixed N^2 mesh at k=1 and k=2 (the mixed bench's timed assembly).
    Returns ({(shape, n, k): row}, {"mixed": displaced counts, "f32":
    displaced counts of the float32 classification})."""
    from proton_tpu_torch.core.geometry import cell_geometry
    from proton_tpu_torch.core.mesh import unit_cell_mesh
    from proton_tpu_torch.cut import fictdom_structured as fs
    from proton_tpu_torch.methods import fused_assembly as fa
    from proton_tpu_torch.solvers.multigrid import _mg_sizes

    f32, dev = torch.float32, torch.device("cuda")
    rows, counts = {}, {"mixed": [], "f32": []}
    for n in _mg_sizes(N, coarsest):
        one = fs._cast(unit_cell_mesh(1.0 / n, device=dev), f32)
        shapes = {"unit": fa.pack_inputs(one, cell_geometry(one))}
        for kind, kw in (("mixed", dict(mixed=True)),
                         ("f32", dict(dtype=f32))):
            mesh, _, _, _, _, dist = fs.classify_cells(
                n, fs.default_problem(), 4, device=dev, **kw)
            geom = cell_geometry(mesh)
            counts[kind].append(len(dist))
            if kind == "mixed" or counts["f32"][-1] != counts["mixed"][-1]:
                shapes[f"displaced_{kind}"] = fa.pack_inputs(*fs._gather_cells(
                    mesh, geom, torch.as_tensor(dist, device=dev)))
            if n == N and kind == "mixed":
                shapes["full"] = fa.pack_inputs(mesh, geom)
            del mesh, geom
        fine = n == N
        for shape, x in shapes.items():
            for k in (1, 2):
                if shape == "displaced_f32" and k == 2:
                    continue
                reps = dict(reps=10, plain_reps=2) if shape == "full" else \
                    dict(reps=200 if fine else 20, plain_reps=20 if fine else 3)
                rows[(shape, n, k)] = kernel_row(x, k + 1, k, 1e-4, bw,
                                                 flop_peak, **reps)
        del shapes
        torch.cuda.empty_cache()
    if "displaced_f32" not in {key[0] for key in rows if key[1] == N}:
        rows[("displaced_f32", N, 1)] = rows[("displaced_mixed", N, 1)]
    return rows, counts


def f32_launches(what: str, expected) -> list:
    """The float32 launches of K1 since its counts were reset: their cell
    counts, which must be ``expected`` (sorted; None: any)."""
    from proton_tpu_torch.methods import fused_assembly as fa

    cells = [c for c, dt in zip(fa.fused_local_operator.launch_cells,
                                fa.fused_local_operator.launch_dtypes)
             if dt == torch.float32]
    line("f32_launches", what=repr(what), launches=len(cells),
         launch_cells=",".join(map(str, cells)))
    check(len(cells) > 0, f"{what}: K1 ran no float32 launch")
    if expected is not None:
        check(sorted(cells) == sorted(expected),
              f"{what}: K1 float32 launched at {cells}, compared at "
              f"{sorted(expected)}")
    return cells


def _mg_f32_against(r, base, N: int, k: int):
    """Print an mg_f32 solve beside the float64 one of the same system:
    (max|local diff|, max|local|)."""
    diff = float((r.local - base.local).abs().max())
    umax = float(base.local.abs().max())
    line("mg_f32_vs_f64", N=N, k=k, iterations=r.iterations,
         iterations_f64=base.iterations,
         ms_per_iteration=1e3 * r.timings["cg_s"] / r.iterations,
         ms_per_iteration_f64=1e3 * base.timings["cg_s"] / base.iterations,
         h1=r.h1_error, h1_f64=base.h1_error, max_abs_local_diff=diff,
         max_abs_local=umax, peak_gb=_peak_gb())
    return diff, umax


def precision_accurate(ref, profile_f64, N: int = 1024, N_k1: int = 512,
                       N_k2: int = 256) -> None:
    """Phase 26 (b), (c): mg_f32=True, tol 1e-11. k=2 at N_k2^2 against
    phase 9's float64 solution (local dofs within 2e-8 of max|local|, H1
    rtol 1e-4); k=1 at N_k1^2 against phase 8's lean solve to phase 7's
    gates against the lean block-Jacobi solve (one discrete system: local
    dofs within 2e-8, H1 rtol 2e-3), then torch.profiler over 10
    iterations at N^2 k=1 beside phase 10's float64 figures
    (``profile_f64``)."""
    lean = dict(fitted="lean", precond="mg")
    r = solve(N_k2, 2, 1e-11, mg_f32=True, **lean)
    diff, umax = _mg_f32_against(r, ref[(N_k2, 2)], N_k2, 2)
    check(diff <= 2e-8 * umax, f"mg_f32 {N_k2}^2 k=2: local dofs {diff} "
          "from phase 9's")
    check(math.isclose(r.h1_error, ref[(N_k2, 2)].h1_error, rel_tol=1e-4),
          f"mg_f32 {N_k2}^2 k=2: H1 {r.h1_error}")
    del r
    torch.cuda.empty_cache()
    r = solve(N_k1, 1, 1e-11, mg_f32=True, **lean)
    diff, _ = _mg_f32_against(r, ref[(N_k1, 1)], N_k1, 1)
    check(diff < 2e-8, f"mg_f32 {N_k1}^2 k=1: local dofs differ by {diff}")
    check(math.isclose(r.h1_error, ref[(N_k1, 1)].h1_error, rel_tol=2e-3),
          f"mg_f32 {N_k1}^2 k=1: H1 {r.h1_error}")
    del r
    torch.cuda.empty_cache()
    prof = profile_mg(N, 1, iterations=10, tag="profile_mg_f32", mg_f32=True)
    if prof and profile_f64:
        line("profile_mg_f32_vs_f64",
             **{f"{key}": f"{prof[key]:.4g}/{profile_f64[key]:.4g}"
                for key in prof if key in profile_f64},
             device_ratio=prof["device"] / profile_f64["device"],
             vcycle_ratio=prof["vcycle"] / profile_f64["vcycle"])
    torch.cuda.empty_cache()


def precision_mixed(expected_cells, h1_f64, N: int = 1024) -> dict:
    """Phase 26 (d): the mixed library solve at N^2 k=1 and k=2, tol 1e-6:
    CG exit 0, finite float32 local dofs, K1's float32 launches at
    ``expected_cells`` (the displaced cells of every level), the H1 error
    within MIXED_H1_LIMITS[k], printed beside phase 7's and 9's float64
    ones (``h1_f64``: {k: H1}) and the JAX CPU test's bound
    (MIXED_H1_CPU_BOUND). Returns {k: the cell counts of the float32
    launches}."""
    from proton_tpu_torch.cut import fictdom_structured as fs

    cells = {}
    for k in (1, 2):
        fs._unit_cell_host.cache_clear()
        r, _, _ = counted_solve("mixed_solve", N, k, 1e-6, mixed=True,
                                fitted="lean", precond="mg")
        cells[k] = f32_launches(f"the mixed {N}^2 k={k} solve",
                                expected_cells)
        low, high = MIXED_H1_LIMITS[k]
        line("mixed_solve", N=N, k=k, exit=r.exit_reason, h1=r.h1_error,
             h1_limits=f"{low:.4g}-{high:.4g}", h1_control=CONTROL_H1[k],
             h1_f64=h1_f64[k],
             h1_cpu_test_bound=MIXED_H1_CPU_BOUND,
             local_dtype=str(r.local.dtype), peak_gb=_peak_gb())
        check(r.local.dtype == torch.float32 and
              bool(torch.isfinite(r.local).all()),
              f"the mixed {N}^2 k={k} solve's local dofs")
        check(low <= r.h1_error <= high, f"the mixed {N}^2 k={k} solve: H1 "
              f"{r.h1_error} outside {low}-{high}")
        del r
        torch.cuda.empty_cache()
    return cells


def precision_f32(expected_cells, N: int = 1024) -> list:
    """Phase 26 (e): cg_segment=50 in the float32 solve at N^2 k=1, tol
    1e-6, capped at 5,000 iterations: exit 0, H1 below F32_H1_LIMIT; K1's
    float32 launches at ``expected_cells`` (the displaced cells of the
    float32 classification). Returns their cell counts."""
    r, _, _ = counted_solve("f32_segmented", N, 1, 1e-6, dtype=torch.float32,
                            cg_segment=50, cap=5000, fitted="lean",
                            precond="mg")
    cells = f32_launches(f"the float32 {N}^2 k=1 solve", expected_cells)
    check(r.exit_reason == 0, f"float32 segmented {N}^2 k=1: exit "
          f"{r.exit_reason} after {r.iterations} iterations")
    line("f32_segmented_h1", N=N, k=1, h1=r.h1_error, h1_limit=F32_H1_LIMIT,
         h1_control=CONTROL_H1[1])
    check(r.h1_error < F32_H1_LIMIT, f"float32 segmented {N}^2 k=1: H1 "
          f"{r.h1_error}, limit {F32_H1_LIMIT}")
    del r
    torch.cuda.empty_cache()
    return cells


# Phase 26 (f): the CG tolerance of the in-process mixed bench at 1024^2
# k=2. Its float32 CG in segments of 50 takes 2,267 iterations (111 s) to
# reach the bench's default 1e-6 on the H100, more than the budget leaves;
# the phase needs the run's K1 launches and its line, and `python -m
# proton_tpu_torch.bench` measures the default (PERF.md).
BENCH_MIXED_TOL = "1e-3"


def precision_cli_start(N_cli: int = 128) -> dict:
    """Phase 26 (f), second half, started: `python -m proton_tpu_torch.bench`
    at PROTON_BENCH_N=N_cli for each precision, as three subprocesses at
    once (mixed in the stock form, f64 at k=2, f32 at k=1). They run while
    (d), (e) and the in-process bench do, after every kernel timing and
    profile of the phase. Returns {precision: (k, label, process)} for
    precision_cli_finish."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PROTON_BENCH_")}
    runs = {}
    try:
        for precision, k, label in (("mixed", None, "mixed(f32+f64-cut)"),
                                    ("f64", "2", "f64(f32-mg-precond)"),
                                    ("f32", "1", "float32")):
            run_env = dict(env, PROTON_BENCH_N=str(N_cli),
                           PROTON_BENCH_PRECISION=precision)
            if k is not None:
                run_env["PROTON_BENCH_K"] = k
            runs[precision] = (k, label, subprocess.Popen(
                [sys.executable, "-m", "proton_tpu_torch.bench"], cwd=root,
                env=run_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
    except BaseException:
        for _, _, proc in runs.values():
            proc.kill()
        raise
    return runs


def precision_cli_finish(runs: dict, t0: float, N_cli: int = 128) -> None:
    """Phase 26 (f), second half, collected: each run of
    precision_cli_start exits 0 with converged lines carrying JAX's label.
    Every process is killed on the way out."""
    try:
        for precision, (k, label, proc) in runs.items():
            out, err = proc.communicate(timeout=600)
            rows = [json.loads(ln) for ln in out.splitlines()
                    if ln.startswith("{")]
            for row in rows:
                print("[precision_bench] " + json.dumps(row), flush=True)
            line("precision_bench_cli", N=N_cli, precision=precision, k=k,
                 exit=proc.returncode, lines=len(rows),
                 seconds=time.perf_counter() - t0)
            check(proc.returncode == 0 and len(rows) == (1 if k else 2) and
                  all(row["precision"] == label and row["cg_exit"] == 0
                      for row in rows) and
                  (k is not None or rows[-1]["k2"].get("cg_exit") == 0),
                  f"the bench CLI with {precision}: exit {proc.returncode}, "
                  f"{len(rows)} lines: {err[-2000:]}")
    finally:
        for _, _, proc in runs.values():
            proc.kill()


def precision_bench(N: int = 1024) -> list:
    """Phase 26 (f), first half: run_bench(N, 2) with
    PROTON_BENCH_PRECISION=mixed in this process (tol BENCH_MIXED_TOL):
    exit 0, JAX's label, K1 in float32 on all N^2 cells twice. Returns the
    cell counts of its float32 launches."""
    import os

    from proton_tpu_torch import bench
    from proton_tpu_torch.methods import fused_assembly as fa

    knobs = [k for k in os.environ if k.startswith("PROTON_BENCH_")]
    check(not knobs, f"phase 26 sets the bench's knobs itself; {knobs} are "
          "set")
    os.environ.update(PROTON_BENCH_PRECISION="mixed",
                      PROTON_BENCH_TOL=BENCH_MIXED_TOL)
    try:
        fa.reset_launch_counts()
        result = bench.run_bench(N, 2)
        cells = f32_launches("the mixed bench at k=2", None)
    finally:
        for name in ("PROTON_BENCH_PRECISION", "PROTON_BENCH_TOL"):
            del os.environ[name]
    print("[precision_bench] " + json.dumps(result), flush=True)
    check(result["cg_exit"] == 0 and
          result["precision"] == "mixed(f32+f64-cut)",
          f"the mixed bench {N}^2 k=2: exit {result['cg_exit']}")
    check(cells.count(N * N) == 2, f"the mixed bench launched K1 in float32 "
          f"on all {N * N} cells {cells.count(N * N)} times")
    del result
    torch.cuda.empty_cache()
    return cells


def precision_gates() -> None:
    """Phase 26 (g): the port's solves of PRECISION_GATES' cases at 16^2
    against the JAX package's CPU numbers (mixed: iterations within 3, H1
    rtol MIXED_GATE_RTOL, as float32 rounds in another order; mg_f32:
    within 2, rtol 1e-6)."""
    for name, (k, tol, options, gate) in PRECISION_GATES.items():
        r = solve(16, k, tol, fitted="lean", precond="mg", **options)
        slack, rtol = (3, MIXED_GATE_RTOL[k]) if options.get("mixed") else \
            (2, 1e-6)
        line("precision_gate", case=name, iterations=r.iterations,
             ref_iterations=gate[0], h1=r.h1_error, ref_h1=gate[2])
        check(abs(r.iterations - gate[0]) <= slack,
              f"16^2 {name}: {r.iterations} iterations, {gate[0]}")
        check(math.isclose(r.h1_error, gate[2], rel_tol=rtol),
              f"16^2 {name}: H1 {r.h1_error}, {gate[2]}")


def precision_phase(ref, profile_f64, bw: float, f32_peak: float,
                    N: int = 1024):
    """Phase 26 [precision]: the JAX package's precision modes on the
    card. ``ref``: {(N, k): the float64 lean + MG solve at tol 1e-11} of
    phases 7 and 9 (reused, not solved again); ``profile_f64``: phase
    10's profile summary. (a) K1 in float32 at every shape of the
    precision paths (f32_shape_rows), then precision_accurate (b, c),
    precision_mixed (d), precision_f32 (e), precision_bench (f) and
    precision_gates (g). Returns {entry name: (launches, row)} of the
    kernels line's float32 entries."""
    rows, counts = f32_shape_rows(N, 8, bw, f32_peak)
    line("f32_displaced_cells", mixed=",".join(map(str, counts["mixed"])),
         float32=",".join(map(str, counts["f32"])))
    torch.cuda.empty_cache()
    precision_accurate(ref, profile_f64, N)
    t0 = time.perf_counter()
    runs = precision_cli_start()
    try:
        mixed = precision_mixed(counts["mixed"],
                                {k: ref[(N, k)].h1_error for k in (1, 2)}, N)
        f32_k1 = precision_f32(counts["f32"], N)
        bench_k2 = precision_bench(N)
    except BaseException:
        for _, _, proc in runs.values():
            proc.kill()
        raise
    precision_cli_finish(runs, t0)
    precision_gates()
    return {"fused_local_operator_f32_mixed_k1_lean":
            (len(mixed[1]), rows[("displaced_mixed", N, 1)]),
            "fused_local_operator_f32_mixed_k2_lean":
            (len(mixed[2]), rows[("displaced_mixed", N, 2)]),
            "fused_local_operator_f32_k1_lean":
            (len(f32_k1), rows[("displaced_f32", N, 1)]),
            "fused_local_operator_f32_mixed_bench_k2":
            (len(bench_k2), rows[("full", N, 2)])}


# Phase 27: the multigrid options the JAX package keeps off by default,
# as solve_fictdom_structured keywords: name -> (options, N at k=1). The
# three whose counts grow fastest run at 128^2 or 256^2 (H100 80GB HBM3,
# 700 W, tol 1e-11; CPU counts of scripts/mg_options_jax_vs_port.py,
# JAX's alike): cheb_ops="mixed" took 13,657 iterations at 1024^2 (647
# s; 830 at 256^2, 261 / 418 at 64^2 / 128^2), "uniform" 4,255 (140 s;
# 865 at 512^2, 187 at 256^2), the cut-aware transfers 1,405 at 512^2
# (72 s; 535 at 256^2, 79 / 206), against the default's 389 at 1024^2,
# 197 at 512^2, 105 at 256^2.
MG_OPTIONS = {"cheb_mixed": (dict(cheb_ops="mixed"), 128),
              "cheb_uniform": (dict(cheb_ops="uniform"), 256),
              "smoothed": (dict(mg_transfer="smoothed"), 1024),
              "cut": (dict(mg_transfer="cut"), 128),
              "deflate": (dict(mg_deflate=4), 1024)}
# the options run at k=2 (the d = 22 shapes of drec and of the band
# features): name -> (N, tol), held to phase 9's solve at that N and tol.
# The cut-aware transfers took 1,864 iterations (96 s) at 256^2 k=2
# against the default's 272, so they run at 64^2 (phase 9's tol 1e-12
# gate solve).
MG_OPTIONS_K2 = {"cut": (64, 1e-12), "deflate": (256, 1e-11)}
# Phase 27: each geometry's H1 error of the float32 family app at
# -N 256 -k 1 -B 8 (PROTON_TPU_X64=0) must lie below twice its reading
# (H100 80GB HBM3, 700 W; float64: 4.6e-4-9.6e-4, phase 21). It is float32
# noise, a quarter of the solution's H1 seminorm on each geometry, and
# the JAX app's is alike (PROTON_TPU_X64=0, CPU: 0.175 ... 0.353). Each
# limit lies below the error of the zero solution, which the phase
# computes (0.70 ... 1.64).
FAMILY_F32_H1 = (0.19747701, 0.22764604, 0.25957298, 0.29217532,
                 0.32356867, 0.35369989, 0.38259912, 0.40999115)
FAMILY_F32_H1_LIMIT = tuple(2 * h for h in FAMILY_F32_H1)


def zero_solution_h1(radii, centers, n: int = 2000):
    """The H1 error of u_h = 0 on each disk, |u|_H1 of the manufactured
    u = sin(pi x) sin(pi y): the midpoint rule on an n x n grid."""
    x = (np.arange(n) + 0.5) / n
    X, Y = np.meshgrid(x, x)
    g = np.pi ** 2 * (np.cos(np.pi * X) ** 2 * np.sin(np.pi * Y) ** 2 +
                      np.sin(np.pi * X) ** 2 * np.cos(np.pi * Y) ** 2)
    return [float(np.sqrt(np.sum(g * ((X - cx) ** 2 + (Y - cy) ** 2 < r * r))
                          / n ** 2)) for r, (cx, cy) in zip(radii, centers)]


def _held_to(tag: str, r, ref, N: int, k: int) -> None:
    """An option's solve against the default solve ``ref`` of the same
    N, k and tol (phases 7, 8, 9 and 22; one discrete system, two
    preconditioners): CG exit 0, local dofs within 2e-8 of max|local|, H1
    rtol 2e-3."""
    diff = float((r.local - ref.local).abs().max())
    umax = float(ref.local.abs().max())
    line("mg_options_vs_default", option=tag, N=N, k=k,
         iterations=r.iterations, iterations_default=ref.iterations,
         ms_per_iteration=1e3 * r.timings["cg_s"] / max(r.iterations, 1),
         ms_per_iteration_default=1e3 * ref.timings["cg_s"] /
         max(ref.iterations, 1),
         h1=r.h1_error, h1_default=ref.h1_error, max_abs_local_diff=diff,
         max_abs_local=umax)
    check(r.exit_reason == 0, f"{tag} {N}^2 k={k}: CG exit {r.exit_reason}")
    check(diff <= 2e-8 * umax, f"{tag} {N}^2 k={k}: local dofs {diff} from "
          "the default solve's")
    check(math.isclose(r.h1_error, ref.h1_error, rel_tol=2e-3),
          f"{tag} {N}^2 k={k}: H1 {r.h1_error}, default {ref.h1_error}")


# Phase 27's bench CLI runs: each knob value of MGTRANSFER, DEFLATE and
# CHEBOPS in one of them (they combine).
MG_OPTIONS_CLI = ({"MGTRANSFER": "cut", "DEFLATE": "4", "CHEBOPS": "mixed"},
                  {"MGTRANSFER": "smoothed", "CHEBOPS": "uniform"})


def mg_options_cli_start(N_cli: int = 128) -> dict:
    """Phase 27: `python -m proton_tpu_torch.bench` at PROTON_BENCH_N=N_cli,
    k=1, once with each knob set of MG_OPTIONS_CLI, as subprocesses at
    once. Returns {index: process}."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PROTON_BENCH_")}
    runs = {}
    try:
        for i, knobs in enumerate(MG_OPTIONS_CLI):
            runs[i] = subprocess.Popen(
                [sys.executable, "-m", "proton_tpu_torch.bench"], cwd=root,
                env=dict(env, PROTON_BENCH_N=str(N_cli), PROTON_BENCH_K="1",
                         **{f"PROTON_BENCH_{k}": v for k, v in knobs.items()}),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    except BaseException:
        for proc in runs.values():
            proc.kill()
        raise
    return runs


# the library keyword each bench knob sets, and its type
MG_KNOBS = {"MGTRANSFER": ("mg_transfer", str), "DEFLATE": ("mg_deflate", int),
            "CHEBOPS": ("cheb_ops", str)}


def mg_options_cli_finish(runs: dict, t0: float, N_cli: int = 128) -> None:
    """Each run of mg_options_cli_start exits 0 with one converged line
    whose "options" name each knob's keyword and value. Every process is
    killed on the way out."""
    try:
        for i, proc in runs.items():
            knobs = MG_OPTIONS_CLI[i]
            out, err = proc.communicate(timeout=600)
            rows = [json.loads(ln) for ln in out.splitlines()
                    if ln.startswith("{")]
            for row in rows:
                print("[mg_options_bench] " + json.dumps(row), flush=True)
            line("mg_options_bench_cli", N=N_cli,
                 knobs=",".join(f"{k}={v}" for k, v in knobs.items()),
                 exit=proc.returncode, lines=len(rows),
                 iterations=rows[-1]["cg_iters"] if rows else None,
                 seconds=time.perf_counter() - t0)
            check(proc.returncode == 0 and len(rows) == 1 and
                  rows[0]["cg_exit"] == 0 and
                  all(rows[0]["options"].get(MG_KNOBS[k][0]) ==
                      MG_KNOBS[k][1](v) for k, v in knobs.items()),
                  f"the bench CLI with {knobs}: exit {proc.returncode}, "
                  f"{len(rows)} lines: {err[-2000:]}")
    finally:
        for proc in runs.values():
            proc.kill()


def mg_options_family(app_f64: dict, bw: float, f32_peak: float,
                      N: int = 256, B: int = 8):
    """Phase 27: the family app at its documented widths with
    PROTON_TPU_X64=0 (float32), K1's launches read around it: all
    converged, no overflow, 8 float32 launches on all N^2 cells,
    each geometry's H1 below FAMILY_F32_H1_LIMIT (printed beside phase
    21's float64 run of the same radii, ``app_f64``, and the zero
    solution's error, above each limit). Then K1 in float32
    against its plain version on the first geometry's displaced mesh.
    Returns (launches, that record row)."""
    import os

    from proton_tpu_torch.apps.fictdom_family import X64_OFF
    from proton_tpu_torch.core.geometry import cell_geometry
    from proton_tpu_torch.core.mesh import make_poly_mesh
    from proton_tpu_torch.cut import fictdom_structured as fs
    from proton_tpu_torch.cut.classify import _preprocess_core
    from proton_tpu_torch.methods import fused_assembly as fa

    check("PROTON_TPU_X64" not in os.environ, "phase 27 sets PROTON_TPU_X64 "
          "itself; it is set")
    os.environ["PROTON_TPU_X64"] = X64_OFF[0]
    try:
        fa.reset_launch_counts()
        out = family_app(["-N", str(N), "-k", "1", "-B", str(B)])
        cells = f32_launches(f"the float32 family app at {N}^2", [N * N] * B)
    finally:
        del os.environ["PROTON_TPU_X64"]
    # the app's geometries (apps/fictdom_family.py)
    radii = np.linspace(0.25, 0.42, B)
    angles = np.linspace(0.0, 2.0 * np.pi, B, endpoint=False)
    centers = 0.5 + 0.02 * np.stack([np.cos(angles), np.sin(angles)], axis=1)
    zero = zero_solution_h1(radii, centers)
    h1, h1_64 = out["h1_errors"], app_f64["h1_errors"]
    line("mg_options_family_f32", N=N, B=B,
         h1=",".join(map(repr, h1)), h1_f64=",".join(map(repr, h1_64)),
         h1_limit=",".join(f"{h:.4g}" for h in FAMILY_F32_H1_LIMIT),
         h1_zero_solution=",".join(f"{h:.4g}" for h in zero),
         iterations=",".join(map(str, out["iterations"])),
         iterations_f64=",".join(map(str, app_f64["iterations"])),
         total_s=out["total_s"], total_s_f64=app_f64["total_s"])
    check(len(h1) == len(FAMILY_F32_H1_LIMIT) and
          all(h < lim < z for h, lim, z in zip(h1, FAMILY_F32_H1_LIMIT,
                                                zero)),
          f"float32 family H1 {h1}, limits {FAMILY_F32_H1_LIMIT}, zero "
          f"solution {zero}")
    radius, center = radii[0], tuple(centers[0])   # the first geometry
    mesh = make_poly_mesh(Nx=N, Ny=N, device="cuda", dtype=torch.float32)
    pts, _, _, _ = _preprocess_core(
        mesh, fs.default_problem(radius, center).ls, 4)
    mesh2 = mesh.with_points(pts)
    row = kernel_row(fa.pack_inputs(mesh2, cell_geometry(mesh2)), 2, 1, 1e-4,
                     bw, f32_peak)
    return len(cells), row


def mg_options_phase(refs, app_f64: dict, bw: float, f32_peak: float):
    """Phase 27 [mg_options]: the multigrid options of
    solve_fictdom_structured on the card, k=1, lean + MG, tol 1e-11, one
    solve for each option of MG_OPTIONS at its N (iterations, ms per
    iteration, setup seconds with drec_setup_s and deflate_setup_s, peak
    GB, K1's launches and cell counts), each held to the default solve of
    the same system (``refs``: {(N, k): result} of phases 7, 9 and 22;
    _held_to); MG_OPTIONS_K2 at k=2 the same way; the bench CLI with
    each knob value (mg_options_cli_start, beside the k=2 runs and the
    family); the float32 family app (mg_options_family). Returns (K1's
    launches in the k=1 option solves, in the k=2 ones, in the family
    app, the family's record row)."""
    launches = {1: 0, 2: 0}
    for name, (options, N) in MG_OPTIONS.items():
        r, n, _ = counted_solve("mg_options_launches", N, 1, 1e-11,
                                fitted="lean", precond="mg", **options)
        launches[1] += n
        _held_to(name, r, refs[(N, 1)], N, 1)
        del r
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runs = mg_options_cli_start()
    try:
        for name, (N, tol) in MG_OPTIONS_K2.items():
            r, n, _ = counted_solve("mg_options_launches", N, 2, tol,
                                    fitted="lean", precond="mg",
                                    **MG_OPTIONS[name][0])
            launches[2] += n
            _held_to(name, r, refs[(N, 2)], N, 2)
            del r
            torch.cuda.empty_cache()
        family = mg_options_family(app_f64, bw, f32_peak)
    except BaseException:
        for proc in runs.values():
            proc.kill()
        raise
    mg_options_cli_finish(runs, t0)
    check(launches[1] > 0 and launches[2] > 0, "the option solves did not "
          "launch K1")
    return launches[1], launches[2], *family


def namespace_phase() -> None:
    """Phase 28: the verify notes' library sample through the package
    namespace, on the card."""
    import proton_tpu_torch as pt
    from proton_tpu_torch.methods import fused_assembly as fa, poisson

    check((pt.BND_NONE, pt.BND_DIRICHLET, pt.BND_NEUMANN, pt.BND_ROBIN) ==
          (0, 1, 2, 3) and pt.__version__ == "0.1.0", "namespace constants")
    rhs, sol, grad = _sin_problem()
    fa.reset_launch_counts()
    prev = None
    for N in (8, 16, 32):
        mesh = pt.make_quad_mesh(Nx=N, Ny=N)
        check(mesh.points.device.type == "cuda", "namespace mesh device")
        hdi = pt.HHODegreeInfo(2, 1)
        dm = pt.assembly.build_dofmap(mesh, hdi)
        s = poisson.solve_poisson(mesh, dm, hdi, rhs, sol)
        e = poisson.compute_errors(mesh, hdi, s, sol, grad)
        l2, en = float(e.l2), float(e.energy)
        check(s.exit_reason == pt.cg.CONVERGED and math.isfinite(l2) and
              math.isfinite(en), f"namespace {N}^2 solve")
        orders = {}
        if prev is not None:
            orders = dict(order_l2=math.log2(prev[0] / l2),
                          order_energy=math.log2(prev[1] / en))
            check(abs(orders["order_l2"] - 3) <= 0.2 and
                  abs(orders["order_energy"] - 2) <= 0.2,
                  f"namespace orders at {N}^2: {orders}")
        line("namespace", N=N, k=1, iterations=s.iterations, l2=l2,
             energy=en, **orders)
        prev = (l2, en)
    check(fa.fused_local_operator.launches == 0,
          "the namespace sample launched K1")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from proton_tpu_torch import native
    from proton_tpu_torch.core.geometry import cell_geometry
    from proton_tpu_torch.core.mesh import make_poly_mesh
    from proton_tpu_torch.methods import fused_assembly as fa

    t_start = time.perf_counter()
    _PHASE_START[0] = t_start
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

    phase_done("1-2 device, build")

    # 3. kernels against their plain version at the flagship mesh
    mesh = make_poly_mesh(Nx=1024, Ny=1024, device="cuda")
    inputs = fa.pack_inputs(mesh, cell_geometry(mesh))
    del mesh
    rows = {}
    for cd, fd, dtype, tol in ((1, 0, torch.float64, 1e-11),
                               (2, 1, torch.float64, 1e-11),
                               (3, 2, torch.float64, 1e-11),
                               (1, 1, torch.float64, 1e-11),
                               (2, 1, torch.float32, 1e-4)):
        x = tuple(a.to(dtype) for a in inputs)
        rows[(cd, fd, dtype)] = kernel_row(
            x, cd, fd, tol, bw,
            f64_peak if dtype == torch.float64 else f32_peak)
        del x
    del inputs
    torch.cuda.empty_cache()

    phase_done("3 kernels")

    # 4. main path: launch counts read around it
    r1024, launches, _ = counted_solve("main_path", 1024, 1, 1e-11)
    check(launches > 0, "the 1024^2 solve did not launch K1")

    # 4b. the assembly phase at the main path's shape, split into its parts
    assembly_split(1024, 1)
    torch.cuda.empty_cache()

    # 4c. where a CG iteration's time goes at the main path's shape
    profile_cg(1024, 1, iterations=60)

    phase_done("4 main path")

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

    phase_done("5 checks")

    # 6. k=2 on the solve path, with its own launch count
    _, launches_k2, _ = counted_solve("k2_path", 256, 2, 1e-10)
    check(launches_k2 > 0, "the 256^2 k=2 solve did not launch K1")

    phase_done("6 k=2")

    # 7. the default path: lean + multigrid at the flagship size
    mg = dict(fitted="lean", precond="mg")
    mg1024, launches_lean, cells = counted_solve("mg_solve", 1024, 1, 1e-11,
                                                 **mg)
    check(launches_lean > 0 and 1 in cells and max(cells) > 1,
          "the lean 1024^2 solve did not launch K1 on the unit cell and on "
          "the displaced cells")
    # Against phase 4 (fitted="full", block-Jacobi). The two discrete
    # systems differ by rounding: a fully assembled regular cell deviates
    # from the unit cell by a rounding error that grows with N
    # (coordinates of size 1 against cells of size 1/N; measured by
    # proton_tpu_torch/tools/lean_vs_full.py), and the condensed system's
    # condition number, ~N^2, turns that into ~1e-7 in the solution at
    # 1024^2, which moves the H1 error (1.2e-6) by 0.4%. It is not
    # algebraic error: the lean system under block-Jacobi (next) agrees
    # with lean + mg thirty times closer.
    local_diff = float((mg1024.local - r1024.local).abs().max())
    line("mg_vs_full_block_jacobi", N=1024, h1_mg=mg1024.h1_error,
         h1_block_jacobi=r1024.h1_error, max_abs_local_diff=local_diff,
         iterations_mg=mg1024.iterations,
         iterations_block_jacobi=r1024.iterations)
    check(math.isclose(mg1024.h1_error, r1024.h1_error, rel_tol=1e-2),
          "1024^2: H1 of lean + mg differs from full + block-Jacobi")
    check(local_diff < 2e-7, f"1024^2: local dofs differ by {local_diff} "
          "from full + block-Jacobi")
    # Against the same lean system under block-Jacobi: one discrete
    # system, two preconditioners, so only algebraic error separates them
    # (at tol 1e-11 the H1 error of one solver moves by 4e-4 relative
    # when the tolerance is tightened to 1e-13).
    bj1024 = solve(1024, 1, 1e-11, fitted="lean", precond="block_jacobi")
    local_diff = float((mg1024.local - bj1024.local).abs().max())
    line("mg_vs_lean_block_jacobi", N=1024, h1_mg=mg1024.h1_error,
         h1_block_jacobi=bj1024.h1_error, max_abs_local_diff=local_diff,
         iterations_block_jacobi=bj1024.iterations,
         iterations_full_block_jacobi=r1024.iterations)
    check(abs(bj1024.iterations - r1024.iterations) <= 0.01 *
          r1024.iterations, "1024^2: lean and full block-Jacobi iterations")
    check(math.isclose(mg1024.h1_error, bj1024.h1_error, rel_tol=2e-3),
          "1024^2: H1 of lean + mg differs from lean + block-Jacobi")
    check(local_diff < 2e-8, f"1024^2: local dofs differ by {local_diff} "
          "from lean + block-Jacobi")
    # phase 23 holds the Galerkin solves against these rediscretized ones,
    # phase 25 the bench's solve against this one
    red = {(1024, 1): mg1024}
    ref_bench = mg1024._replace(local=None)
    del r1024, mg1024, bj1024
    torch.cuda.empty_cache()

    phase_done("7 default path")

    # 7b. K1 against its plain version at the shapes the lean and the
    # multigrid paths give it, on every level
    shape_rows, displaced_cells = path_shape_rows(1024, 8, bw, f64_peak)
    check_lean_launches("the lean 1024^2 k=1 solve", cells, displaced_cells)

    phase_done("7b K1 at the path shapes")

    # 8. full + multigrid (K1 on every cell of every level) against lean,
    # and the JAX package's lean + multigrid gates
    full512, launches_full_mg, cells = counted_solve(
        "mg_full", 512, 1, 1e-11, fitted="full", precond="mg")
    check(cells == [n * n for n in (512, 256, 128, 64, 32, 16, 8)],
          f"full + mg at 512^2 launched K1 at {cells}")
    lean512 = solve(512, 1, 1e-11, **mg)
    # The two hierarchies differ by the full assembly's rounding (phase
    # 7), and the V-cycle leaves outlier modes to CG, so the counts drift
    # apart with N: 34/34, 61/62, 105/108 at 64^2, 128^2, 256^2 and
    # 206/197 at 512^2 (proton_tpu_torch/tools/lean_vs_full.py). Held to
    # 5%.
    check(abs(full512.iterations - lean512.iterations) <=
          0.05 * lean512.iterations,
          "512^2: full + mg and lean + mg iteration counts differ")
    # measured 4e-6 and 3e-6 apart: the full assembly's rounding again
    check(math.isclose(full512.h1_error, lean512.h1_error, rel_tol=1e-4),
          "512^2: H1 of full + mg differs from lean + mg")
    check(math.isclose(lean512.h1_error, r512.h1_error, rel_tol=1e-4),
          "512^2: H1 of lean + mg differs from full + block-Jacobi")
    # phase 26 holds the float32 V-cycle at 512^2 k=1 against lean512
    red[(512, 1)] = lean512
    del full512, lean512
    for n, slack in ((32, 1), (64, 2)):
        r = solve(n, 1, 1e-10, **mg)
        line("mg_gate", N=n, iterations=r.iterations,
             ref_iterations=MG_GATES[n][0], h1=r.h1_error,
             ref_h1=MG_GATES[n][1])
        check(abs(r.iterations - MG_GATES[n][0]) <= slack,
              f"{n}^2 lean + mg iterations")
        check(math.isclose(r.h1_error, MG_GATES[n][1], rel_tol=1e-6),
              f"{n}^2 lean + mg H1")

    phase_done("8 full + mg")

    # 9. k=2 on the default path: the JAX package's gates, then up to the
    # 1024^2 configuration. The H1 error no longer falls at the cubic
    # rate there (see MG_GATES_K2): it must not rise, and its orders are
    # printed.
    for n, (ref_iterations, ref_h1) in MG_GATES_K2.items():
        r = red[(n, 2)] = solve(n, 2, 1e-12, **mg)  # phase 27 reuses them
        line("mg_gate_k2", N=n, iterations=r.iterations,
             ref_iterations=ref_iterations, h1=r.h1_error, ref_h1=ref_h1)
        check(abs(r.iterations - ref_iterations) <= 2,
              f"{n}^2 k=2 lean + mg iterations")
        check(math.isclose(r.h1_error, ref_h1, rel_tol=1e-4),
              f"{n}^2 k=2 lean + mg H1")
    h1_k2 = {128: r.h1_error}
    red[(256, 2)] = solve(256, 2, 1e-11, **mg)
    h1_k2[256] = red[(256, 2)].h1_error
    r, launches_k2_lean, cells = counted_solve("mg_solve_k2", 1024, 2, 1e-11,
                                               **mg)
    h1_k2[1024] = r.h1_error
    red[(1024, 2)] = r
    del r
    torch.cuda.empty_cache()
    check(launches_k2_lean > 0, "the lean 1024^2 k=2 solve did not launch K1")
    check_lean_launches("the lean 1024^2 k=2 solve", cells, displaced_cells)
    pairs = ((128, 256), (256, 1024))
    line("order_k2", **{f"h1_{n}": h for n, h in h1_k2.items()},
         **{f"order_{a}_{b}": math.log2(h1_k2[a] / h1_k2[b]) /
            math.log2(b // a) for a, b in pairs})
    for a, b in pairs:
        check(h1_k2[b] <= 1.05 * h1_k2[a], f"k=2 H1 rises from {a}^2 to "
              f"{b}^2")

    phase_done("9 k=2 default path")

    # 10. where a multigrid-PCG iteration's time goes
    profile_f64 = profile_mg(1024, 1, iterations=10)
    torch.cuda.empty_cache()

    phase_done("10 profile_mg")

    # 11-15. the uncut HHO path
    t_uncut = time.perf_counter()
    hho_vs_k1(1024, bw)
    phase_done("11 hho")
    convergence_table()
    phase_done("12 convergence")
    poisson_1024()
    phase_done("13 poisson_1024")
    obstacle_table()
    phase_done("14 obstacle")
    polymesh_bricks()
    phase_done("15 polymesh")
    line("uncut_total", seconds=round(time.perf_counter() - t_uncut, 3))

    # 16-20. the generic cut path
    t_cut = time.perf_counter()
    cut_preprocess_phase()
    phase_done("16 cut_preprocess")
    fictdom_generic_phase()
    phase_done("17 fictdom_generic")
    interface_phase()
    phase_done("18 interface")
    agglomerate_phase()
    phase_done("19 agglomerate")
    cuthho_square_phase()
    phase_done("20 cuthho_square")
    line("cut_total", seconds=round(time.perf_counter() - t_cut, 3))

    # 21-22. the geometry families, and the structured-solve options
    t_family = time.perf_counter()
    family_row, launches_family, app_f64 = family_phase(bw, f64_peak)
    phase_done("21 family")
    red.update({(n, 1): r for n, r in options_phase().items()})
    phase_done("22 options")
    line("family_total", seconds=round(time.perf_counter() - t_family, 3))

    # 23. the Galerkin coarse hierarchy
    launches_gal, launches_gal_k2 = galerkin_phase(red, displaced_cells)
    # phase 26 holds the precision modes against the float64 solutions
    ref_precision = {key: red[key] for key in ((1024, 1), (512, 1),
                                               (1024, 2), (256, 2))}
    # phase 27 holds the multigrid options against these
    ref_options = {key: red[key] for key in ((1024, 1), (256, 1), (128, 1),
                                             (64, 2), (256, 2))}
    del red
    torch.cuda.empty_cache()
    phase_done("23 galerkin")

    # 24. proton_tpu_torch.parallel on one rank over NCCL
    parallel_phase()
    phase_done("24 parallel")

    # 25. the bench entry point
    launches_bench = bench_phase(ref_bench, displaced_cells)
    phase_done("25 bench")

    # 26. the precision modes
    f32_entries = precision_phase(ref_precision, profile_f64, bw, f32_peak)
    del ref_precision
    phase_done("26 precision")

    # 27. the multigrid options
    (launches_options, launches_options_k2, launches_family_f32,
     family_f32_row) = mg_options_phase(ref_options, app_f64, bw, f32_peak)
    del ref_options
    phase_done("27 mg_options")

    # 28. the package namespace
    namespace_phase()
    phase_done("28 namespace")

    line("total", seconds=round(time.perf_counter() - t_start, 3))
    print(smi, flush=True)
    record = dict(route="cuda", source="proton_tpu_torch/csrc/fused_assembly.cu",
                  replaces="proton_tpu/methods/pallas_assembly.py:315",
                  library_ms=None)
    print(json.dumps({"kernels": [
        dict(name="fused_local_operator", launches=launches, **record,
             **rows[(2, 1, torch.float64)]),
        dict(name="fused_local_operator_k2", launches=launches_k2, **record,
             **rows[(3, 2, torch.float64)]),
        dict(name="fused_local_operator_lean", launches=launches_lean,
             **record, **shape_rows[("displaced", 1024, 1)]),
        dict(name="fused_local_operator_k2_lean", launches=launches_k2_lean,
             **record, **shape_rows[("displaced", 1024, 2)]),
        dict(name="fused_local_operator_full_mg", launches=launches_full_mg,
             **record, **shape_rows[("full", 512, 1)]),
        dict(name="fused_local_operator_family", launches=launches_family,
             **record, **family_row),
        dict(name="fused_local_operator_galerkin", launches=launches_gal,
             **record, **shape_rows[("displaced", 1024, 1)]),
        dict(name="fused_local_operator_k2_galerkin",
             launches=launches_gal_k2, **record,
             **shape_rows[("displaced", 256, 2)]),
        dict(name="fused_local_operator_bench", launches=launches_bench,
             **record, **shape_rows[("full", 1024, 1)]),
        dict(name="fused_local_operator_mg_options",
             launches=launches_options, **record,
             **shape_rows[("displaced", 1024, 1)]),
        dict(name="fused_local_operator_k2_mg_options",
             launches=launches_options_k2, **record,
             **shape_rows[("displaced", 256, 2)]),
        dict(name="fused_local_operator_f32_family",
             launches=launches_family_f32, **record, **family_f32_row),
        *(dict(name=name, launches=n, **record, **row)
          for name, (n, row) in f32_entries.items())]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
