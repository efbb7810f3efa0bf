"""K1 variants on the card, timed in turns, with per-phase clocks.

    python3 -m proton_tpu_torch.tools.k1_variants '{"base": {}, "w6": {"warps": "fd == 0 ? 4 : fd == 1 ? 6 : 8"}}'

Each variant is csrc/fused_assembly.cu with edits, built with nvcc into
build/k1_variants/ (all builds started together):

- ``warps`` / ``minb``: a C expression in ``cd`` and ``fd`` that replaces
  the body of ``warps_for`` / ``min_blocks_for``;
- ``subs``: [[regex, replacement], ...] applied to the source;
- ``storeonly``: 1 drops P1 and P2, so P3 stores whatever shared memory
  holds: the store stream alone, for the ceiling of the output pattern;
- ``notime``: 1 builds the variant for its ptxas figures only.

For each variant the script prints the registers, stack and spills of
every instantiation; then, for K1 at 1024^2 cells in float64 at k=0, 1, 2
and (1, 1) and in float32 at k=1 (or the pairs named in a second
argument, e.g. "2,1,8;3,2,8", with bytes per value last): the error
against the plain version, the time of 20 launches twice in the order
A B .. B A (CUDA events), the share of the bytes bound, and from a copy
of the variant that reads clock64() at its barriers the median cycles of
P1, P2, P3 and of a whole tile for the third tile of each block; and the
time of ``zero_()`` on the same output tensor, a contiguous write of the
same bytes. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..core.bases import _exponent_tables
from ..core.geometry import cell_geometry
from ..core.mesh import make_poly_mesh
from ..core.quadrature import gauss_legendre
from ..methods import fused_assembly as fa

OUT = native.BUILD_DIR.parent / "k1_variants"
CONFIGS = ((1, 0, torch.float64), (2, 1, torch.float64), (3, 2, torch.float64),
           (1, 1, torch.float64), (2, 1, torch.float32))
CLOCK_SLOTS = 8


def _source(spec: dict, clock: bool) -> str:
    s = (native.CSRC / "fused_assembly.cu").read_text()
    for key, fn in (("warps", "warps_for"), ("minb", "min_blocks_for")):
        if key in spec:
            s, n = re.subn(r"(constexpr int " + fn + r"\(int cd, int fd\) \{\s*)return [^;]*;",
                           lambda m: m.group(1) + f"return {spec[key]};", s)
            assert n == 1, fn
    for pat, rep in spec.get("subs", []):
        s, n = re.subn(pat, rep, s)
        assert n >= 1, pat
    if spec.get("storeonly"):
        for pat, rep in ((r"r \* S::WARPS < S::JOBS;", "false;"),
                         (r"if \(warp < S::D\) solve_columns", "if (false) solve_columns")):
            s, n = re.subn(pat, rep, s)
            assert n == 1, pat
    if clock:
        s = s.replace("namespace {\n", f"__device__ long long k1_clk[32768 * {CLOCK_SLOTS}];\n"
                      "namespace {\n", 1)
        body = s[s.index("fused_assembly_kernel(Inputs<T>"):
                 s.index("// Launch constants of one instantiation")]
        loop_at = body.index("for (long long tile = blockIdx.x; tile < tiles;")
        head, loop = body[:loop_at], body[loop_at:]
        eol = loop.index("\n") + 1
        loop = (loop[:eol] + "    const long long k1_t0 = clock64();\n"
                "    const bool k1_rec = threadIdx.x == 0 && tile == blockIdx.x + 2 * gridDim.x;\n"
                + loop[eol:])
        count = [0]

        def stamp(_):
            count[0] += 1
            return (f"__syncthreads();\n    if (k1_rec) {{ k1_clk[blockIdx.x * {CLOCK_SLOTS}] = k1_t0;"
                    f" k1_clk[blockIdx.x * {CLOCK_SLOTS} + {count[0]}] = clock64(); }}")
        loop = re.sub(r"__syncthreads\(\);", stamp, loop)
        assert count[0] == 3, count[0]
        s = s.replace(body, head + loop)
        s += ('\nstatic long long k1_zeros[sizeof(k1_clk) / 8];\n'
              'extern "C" int k1_read_clk(long long* h) {'
              ' return (int)cudaMemcpyFromSymbol(h, k1_clk, sizeof(k1_clk)); }\n'
              'extern "C" int k1_zero_clk() {'
              ' return (int)cudaMemcpyToSymbol(k1_clk, k1_zeros, sizeof(k1_clk)); }\n')
    return s


def _build(tag: str):
    cmd = [native._nvcc(), *native.NVCC_FLAGS, "-o", str(OUT / f"{tag}.so"),
           str(OUT / f"{tag}.cu")]
    return tag, subprocess.run(cmd, capture_output=True, text=True)


def _launch(lib, x, out, cd, fd):
    """Launch the variant at the geometry it was compiled for: the warps
    are found by asking until the launcher stops refusing (-3)."""
    gx, gw = (np.ascontiguousarray(a, np.float64) for a in gauss_legendre(2 * fd + 2))
    fx, fw = (np.ascontiguousarray(a, np.float64) for a in gauss_legendre(2 * fd))
    px, py = (np.ascontiguousarray(a, np.int32) for a in _exponent_tables(fd + 1))
    smem = fa.shared_rows(cd, fd) * 32 * out.element_size()
    for warps in range(1, 33):
        code = lib.fused_assembly_launch(
            int(out.dtype == torch.float64), cd, fd, *(a.data_ptr() for a in x),
            out.data_ptr(), out.shape[1], gx.ctypes.data, gw.ctypes.data, len(gx),
            fx.ctypes.data, fw.ctypes.data, len(fx), px.ctypes.data, py.ctypes.data,
            len(px), 32, warps, smem, torch.cuda.current_stream().cuda_stream)
        if code != -3:
            break
    if code != 0:
        raise RuntimeError(lib.fused_assembly_error_string(code).decode())


def main(argv) -> int:
    import chip_smoke as cs

    variants = json.loads(argv[1]) if len(argv) > 1 else {"base": {}}
    configs = CONFIGS
    if len(argv) > 2:
        wanted = set(argv[2].split(";"))
        configs = [c for c in CONFIGS
                   if f"{c[0]},{c[1]},{torch.finfo(c[2]).bits // 8}" in wanted]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    tags = []
    for name, spec in variants.items():
        for clock in (False,) if spec.get("notime") else (False, True):
            tag = name + ("_clk" if clock else "")
            (OUT / f"{tag}.cu").write_text(_source(spec, clock))
            tags.append(tag)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(tags)) as pool:
        builds = list(pool.map(_build, tags))
    print("build_s", round(time.perf_counter() - t0, 3), flush=True)
    libs = {}
    for tag, r in builds:
        if r.returncode:
            print("build failed", tag, r.stdout[-3000:], r.stderr[-3000:])
            return 1
        if not tag.endswith("_clk"):
            (OUT / f"{tag}.ptxas.log").write_text(r.stdout + r.stderr)
            for key, val in sorted(cs.ptxas_summary(r.stdout + r.stderr).items()):
                print("ptxas", tag, key, "registers, stack, spill stores, spill loads", val,
                      flush=True)
        lib = ctypes.CDLL(str(OUT / f"{tag}.so"))
        lib.fused_assembly_launch.argtypes = fa._library().fused_assembly_launch.argtypes
        lib.fused_assembly_error_string.restype = ctypes.c_char_p
        lib.fused_assembly_occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        libs[tag] = lib
    names = [n for n, spec in variants.items() if not spec.get("notime")]

    mesh = make_poly_mesh(Nx=1024, Ny=1024, device="cuda")
    inputs = fa.pack_inputs(mesh, cell_geometry(mesh))
    C = mesh.num_cells
    del mesh
    bw = cs.peaks(torch.cuda.get_device_name(0))[1]
    for cd, fd, dtype in configs:
        x = tuple(a.to(dtype) for a in inputs)
        ref = fa.fitted_local_operator_plain(*x, cd, fd)
        out = torch.empty(ref.shape, dtype=dtype, device="cuda")
        d = int(round(ref.shape[0] ** 0.5))
        bound_ms = (40 + d * d) * out.element_size() * C / bw * 1e3
        rel, blocks = {}, {}
        for name in names:
            n = ctypes.c_int(0)
            libs[name].fused_assembly_occupancy(int(dtype == torch.float64), cd, fd,
                                                ctypes.addressof(n))
            blocks[name] = n.value
            out.fill_(float("nan"))
            _launch(libs[name], x, out, cd, fd)
            torch.cuda.synchronize()
            rel[name] = float((out - ref).abs().max() / ref.abs().max())
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                times[name].append(cs.cuda_ms(lambda: _launch(libs[name], x, out, cd, fd), 20))
        fill_ms = cs.cuda_ms(out.zero_, 20)
        print(f"K1 <{cd},{fd}> {str(dtype)[6:]} output zero_(): ms {fill_ms:.4f} "
              f"share of the memory rate {out.numel() * out.element_size() / bw / fill_ms * 1e3:.3f}",
              flush=True)
        for name in names:
            lib = libs[name + "_clk"]
            lib.k1_zero_clk()
            _launch(lib, x, out, cd, fd)
            torch.cuda.synchronize()
            clk = np.zeros(32768 * CLOCK_SLOTS, dtype=np.int64)
            lib.k1_read_clk(ctypes.c_void_p(clk.ctypes.data))
            clk = clk.reshape(-1, CLOCK_SLOTS)
            clk = clk[clk[:, 3] > 0]
            phases = np.median(np.diff(clk[:, :4], axis=1), axis=0)
            ms = min(times[name])
            print(f"K1 <{cd},{fd}> {str(dtype)[6:]} {name}: blocks/SM {blocks[name]} "
                  f"rel_err {rel[name]:.2e} ms {ms:.4f} runs {[round(t, 4) for t in times[name]]} "
                  f"bound_share {bound_ms / ms:.3f} cycles P1 {phases[0]:.0f} P2 {phases[1]:.0f} "
                  f"P3 {phases[2]:.0f} tile {np.median(clk[:, 3] - clk[:, 0]):.0f} "
                  f"(blocks sampled {len(clk)})", flush=True)
        del x, out, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
