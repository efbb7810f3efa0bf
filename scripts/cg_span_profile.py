"""Where a CG iteration's host time goes, by the program's spans
(proton_tpu_torch/utils/timing.py), on the cutHHO fictitious-domain
solve: lean system, multigrid V-cycle under CG, float64.

1. The cost of one span: no sink, a sink, a sink under a running
   torch.profiler (the span then opens a record_function range), in µs.
2. With ``--ab R``: R rounds of ``--ab-iters`` CG iterations with the CG
   and V-cycle spans on and stubbed out, back to back, in ms an
   iteration, and the mean on/off ratio of a round with its standard
   error.
3. One timeline of ``--iters`` CG iterations, CPU and CUDA activity, after
   ``--warm`` unprofiled ones: for each span name its calls, host ms a
   call, the kernels launched inside it a call, and their device ms a
   call; and the same per CG iteration. The Chrome trace is written to
   ``--trace-out`` (not committed: it is tens of MB).

Usage (on the card):
    python scripts/cg_span_profile.py --N 1024 --k 1 \
        --trace-out cg_spans_k1.json
On the CPU it runs at a small N (kernels then read 0).
"""

import argparse
import os
import statistics
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
from torch.profiler import ProfilerActivity, profile

from proton_tpu_torch.core.ops import HHODegreeInfo
from proton_tpu_torch.cut import fictdom_structured as fs
from proton_tpu_torch.solvers import cg
from proton_tpu_torch.utils.timing import sink, span


def span_cost_us(n: int) -> dict:
    """µs per `with span(...)` with no sink, with one, and with one under
    a profiler recording CPU activity."""
    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with span("x"):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    out = {"no_sink": loop()}
    with sink({}):
        out["sink"] = loop()
        with profile(activities=[ProfilerActivity.CPU]):
            out["sink_profiled"] = loop()
    return out


class _Off:
    """A span that does nothing: what the spans' cost is read against."""

    def __init__(self, name, device=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def ab_ms_per_iter(run, rounds: int, iters: int) -> dict:
    """ms per CG iteration with the CG and V-cycle spans on and with them
    stubbed out (solvers/cg.py's and solvers/multigrid.py's ``span``
    replaced by _Off), in rounds of ``iters`` iterations each way, the
    order turning each round: on, off, off, on, ..."""
    from proton_tpu_torch.solvers import multigrid
    on = cg.span
    out = {"on": [], "off": []}
    for r in range(rounds):
        for mode in ("on", "off") if r % 2 == 0 else ("off", "on"):
            cg.span = multigrid.span = on if mode == "on" else _Off
            t = {}
            try:
                run(iters, t)
            finally:
                cg.span = multigrid.span = on
            out[mode].append(1e3 * t["cg_s"] / iters)
    return out


def kernels(e) -> tuple:
    """(device events, their seconds) launched under host event ``e``."""
    n, s = len(e.kernels), sum(k.duration for k in e.kernels) * 1e-6
    for c in e.cpu_children:
        cn, cs = kernels(c)
        n, s = n + cn, s + cs
    return n, s


def by_span(events) -> dict:
    """{span name: [calls, host s, kernels, device s]} of the CPU user
    annotations that are the program's spans (cg_*, mg_*, galerkin.*)."""
    out = defaultdict(lambda: [0, 0.0, 0, 0.0])
    for e in events:
        if e.device_type.name != "CPU" or not e.name.startswith(
                ("cg_", "mg_", "galerkin.")):
            continue
        n, s = kernels(e)
        row = out[e.name]
        row[0] += 1
        row[1] += (e.time_range.end - e.time_range.start) * 1e-6
        row[2] += n
        row[3] += s
    return dict(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=1024)
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--warm", type=int, default=20)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--span-loops", type=int, default=200_000)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--ab", type=int, default=0,
                    help="rounds of spans on / stubbed out")
    ap.add_argument("--ab-iters", type=int, default=5,
                    help="CG iterations each way in a round")
    args = ap.parse_args()

    card = torch.cuda.is_available()
    dev = torch.device("cuda" if card else "cpu")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0) if card else 'cpu'}",
          flush=True)
    print("span_cost_us " + " ".join(
        f"{k}={v:.3f}" for k, v in span_cost_us(args.span_loops).items()),
        flush=True)

    N, k = args.N, args.k
    hdi, eta, problem = HHODegreeInfo(k + 1, k), fs.nitsche_eta(k), \
        fs.default_problem()
    level = fs.build_level(N, hdi, problem, eta, 4, device=dev,
                           fitted="lean")
    vcycle = fs.mg_preconditioner(level, N, hdi, problem, eta, 4,
                                  device=dev)
    fsys = fs.face_system(level, N, hdi, problem, "mg", device=dev)

    def run(iters, timings):
        # CG exits once its count passes max_iter: max_iter + 2 iterations
        params = cg.CGParams(convergence_threshold=1e-30,
                             divergence_threshold=1e8, max_iter=iters - 2,
                             apply_preconditioner=True)
        with sink(timings), span("cg", dev):
            res = cg.conjugated_gradient(fsys.apply_S, fsys.rhs, None,
                                         params, precond=vcycle)
        assert res.iterations == iters, res.iterations
        return res

    warm = {}
    run(args.warm, warm)
    print(f"warm N={N} k={k} iterations={args.warm} "
          f"cg_iter_ms={1e3 * warm['cg_s'] / args.warm:.3f} " + " ".join(
              f"{key}_ms_per_iter={1e3 * warm[key + '_s'] / args.warm:.3f}"
              for key in ("cg_apply", "cg_precond", "cg_wait", "cg_self")),
          flush=True)

    if args.ab:
        ab = ab_ms_per_iter(run, args.ab, args.ab_iters)
        for mode, v in ab.items():
            print(f"ab {mode} ms_per_iter median {statistics.median(v):.3f} "
                  f"quartiles {statistics.quantiles(v, n=4)}", flush=True)
        # each round's two blocks ran back to back: their ratio drifts
        # less with the host's pace than the medians do
        ratio = [a / b for a, b in zip(ab["on"], ab["off"])]
        print(f"ab on/off rounds {len(ratio)} mean "
              f"{statistics.mean(ratio):.4f} se "
              f"{statistics.stdev(ratio) / len(ratio) ** 0.5:.4f} median "
              f"{statistics.median(ratio):.4f}", flush=True)

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=acts) as prof:
        run(args.iters, {})
    if args.trace_out:
        prof.export_chrome_trace(args.trace_out)
    rows = by_span(prof.events())
    it = args.iters
    print("span calls/iter host_ms/call kernels/call device_ms/call "
          "host_us/kernel")
    for name in sorted(rows, key=lambda n: -rows[n][1]):
        calls, host, n, dsec = rows[name]
        print(f"{name} {calls / it:g} {1e3 * host / calls:.4f} "
              f"{n / calls:.1f} {1e3 * dsec / calls:.4f} "
              f"{1e6 * host / n if n else float('nan'):.2f}", flush=True)
    total_k = sum(kernels(e)[0] for e in prof.events()
                  if e.device_type.name == "CPU" and e.name == "cg")
    fine = max((int(n.rsplit("_n", 1)[1]) for n in rows
                if n.startswith("mg_")), default=0)
    fine_rows = [r for n, r in rows.items() if n.startswith("mg_") and
                 n.endswith(f"_n{fine}")]
    print(f"per_iteration kernels={total_k / it:.1f} "
          f"vcycle_kernels={rows['cg_precond'][2] / it:.1f} "
          f"fine_kernels={sum(r[2] for r in fine_rows) / it:.1f} "
          f"fine_host_ms={1e3 * sum(r[1] for r in fine_rows) / it:.3f} "
          f"fine_device_ms={1e3 * sum(r[3] for r in fine_rows) / it:.3f} "
          f"vcycle_host_ms={1e3 * rows['cg_precond'][1] / it:.3f} "
          f"vcycle_device_ms={1e3 * rows['cg_precond'][3] / it:.3f}",
          flush=True)


if __name__ == "__main__":
    main()
