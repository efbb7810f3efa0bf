"""The benchmark's core: one run of one cell.

A run is one process. It finds its cell in ``BENCHMARK.json`` and
everything the cell names as a file of its own under ``benchmark/``:

- ``configs/<config>.json``: the configuration (mesh, degree, method
  parameters) as it is run;
- ``traffic/<traffic>.json``: the traffic mix, read by the one generator
  ``traffic/generate.py``; its ``driver`` names ``drivers/<driver>.py``,
  which runs one problem through the system under test and judges it
  against the plain reference;
- ``workloads/<cell>.json``: the limits of the numbers compared and the
  traced slice;
- ``metrics/<metric>.py``: one reader per metric, ``read(run)``, which
  returns a number or None (then the metric is left out of the line).

Set-up (imports, CUDA context, the kernels loaded or built, one warm-up
problem) is ``setup_s``; standard error gives it by part (``setup
parts``) and the warm-up problem's spans (``setup warm``). Then whole
problems run back to back: a new one starts while fewer than ``seconds``
have elapsed or while the traffic pool's round is unfinished, and the one
running when they elapse finishes and counts. After the window the peak
memory is read, the program's state is freed, every problem's answer is
judged, the process is checked for JAX, and the last line of standard
output is the result.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path
from typing import List, Optional

import torch

BENCH_DIR = "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "proton_tpu")


class HarnessError(Exception):
    """A run that cannot be made: a bad manifest, a missing file, no card."""


@dataclasses.dataclass
class Problem:
    """One problem of the window as the driver returns it."""

    params: dict
    seconds: float
    outcome: object


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    window_s: float
    problems: List[Problem]
    peak_bytes: int
    trace: Optional[object] = None     # trace.Slice of a --trace 1 run


def load_module(path: Path):
    """The module in the file ``path``, loaded under its own name."""
    if not path.is_file():
        raise HarnessError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"_bench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise HarnessError(f"no file {path}")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    """A cell of the manifest with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    trace: dict
    end_to_end: list
    per_layer: list
    root: Path

    def driver(self):
        return load_module(self.root / BENCH_DIR / "drivers" /
                           f"{self.traffic['driver']}.py")

    def generator(self):
        return load_module(self.root / BENCH_DIR / "traffic" / "generate.py")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    manifest = load_json(root / "BENCHMARK.json")
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise HarnessError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    bench = root / BENCH_DIR
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    cell = load_json(bench / "workloads" / f"{name}.json")
    return Cell(
        name, int(entry["chips"]), config,
        load_json(bench / "traffic" / f"{entry['traffic']}.json"),
        cell["limits"], cell.get("trace", {}),
        [m for m in manifest["end_to_end"] if _applies(m, name)],
        [m for m in manifest["per_layer"] if _applies(m, name)], root)


def require_cards(chips: int) -> torch.device:
    """The first card; refuses a machine with fewer cards than the cell
    asks for. There is no fallback to the CPU."""
    if not torch.cuda.is_available():
        raise HarnessError("no CUDA device: the benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise HarnessError(f"the cell needs {chips} cards, the machine has "
                           f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(cell: Cell, driver, problems, seconds: float,
               device: torch.device):
    """Whole problems back to back while fewer than ``seconds`` have
    elapsed since the window opened, and then to the end of the traffic
    pool's round, so that every run solves whole rounds. Returns (window
    seconds, problems, errors); an error ends the window."""
    done, errors = [], []
    clock = time.perf_counter
    w0 = clock()
    round_ended = True
    while not done or clock() - w0 < seconds or not round_ended:
        params, round_ended = next(problems)
        t0 = clock()
        try:
            outcome = driver.run(cell.config, params, device)
            _sync(device)
        except Exception:  # the run reports it as a failed problem
            errors.append(traceback.format_exc())
            break
        done.append(Problem(params, clock() - t0, outcome))
    return clock() - w0, done, errors


def _number(v: float) -> str:
    return f"{v:.6g}"


def judge_all(cell: Cell, driver, done: List[Problem], device):
    """Each problem's numbers against the cell's limits. Returns (number
    of failed problems, worst reading of each number)."""
    worst, failed = {}, 0
    for p in done:
        numbers = driver.judge(cell.config, p.params, p.outcome, device)
        bad = False
        for name, value in numbers.items():
            limit = cell.limits[name]
            worst[name] = max(worst.get(name, value), value)
            bad |= not value <= limit
        failed += bad
    return failed, worst


def measure(root: Path, name: str, seed: int, seconds: float, trace: bool,
            t_start: float, device: Optional[torch.device] = None,
            stderr=sys.stderr):
    """One run: returns the result line (a dict) and the check lines.
    ``device`` is found from the cell's chips unless given (the CPU tests
    give it)."""
    clock = time.perf_counter
    marks = [("import_s", clock())]
    cell = load_cell(root, name)
    if device is None:
        device = require_cards(cell.chips)
    _sync(device)
    marks.append(("context_s", clock()))
    driver = cell.driver()
    problems = cell.generator().problems(cell.traffic, cell.config, seed)
    marks.append(("driver_s", clock()))
    warm_timings = driver.warm(cell.config, device)
    _sync(device)
    marks.append(("warm_s", clock()))
    setup_s = marks[-1][1] - t_start
    print(f"setup {setup_s:.3f} s", file=stderr, flush=True)
    # set-up by part: the imports before the run, the CUDA context, the
    # program's and the reference's imports, the warm-up problem (and its
    # spans, where the driver returns them)
    ends = [t_start] + [t for _, t in marks]
    print("setup parts " + json.dumps(
        {part: round(t - ends[i], 4) for i, (part, t) in enumerate(marks)}),
        file=stderr, flush=True)
    if warm_timings:
        print("setup warm " + json.dumps(warm_timings), file=stderr,
              flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window_s, done, errors = run_window(cell, driver, problems, seconds,
                                        device)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    for p in done:
        print(f"problem {json.dumps(p.params)} {p.seconds:.4f} s "
              f"{driver.describe(p.outcome)}", file=stderr, flush=True)
    for e in errors:
        print(e, file=stderr, flush=True)
    traced = None
    if trace and done:
        from . import trace as trace_mod
        traced = trace_mod.SliceTracer(device, **cell.trace).profile(
            lambda cap: driver.run(cell.config, done[0].params, device,
                                   max_iter=cap))
    driver.release(device)

    failed, worst = judge_all(cell, driver, done, device)
    failed += len(errors)
    run = Run(setup_s, window_s, done, peak, traced)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module(root / BENCH_DIR / "metrics" /
                            f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    result = {"correct": failed == 0 and bool(done) and
              set(worst) == set(cell.limits),
              "attempted": len(done) + len(errors), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else "cpu", "kind": kind, "count": cell.chips,
                         "memory_peak_bytes": int(peak)}}
    if traced is not None:
        result["device"]["busy_s"] = traced.busy_s
        result["device"]["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown()
    result["checks"] = {k: {"value": worst[k], "limit": cell.limits[k]}
                        for k in cell.limits if k in worst}
    lines = [f"check {k} {_number(worst[k])} limit "
             f"{_number(cell.limits[k])} "
             f"{'ok' if worst[k] <= cell.limits[k] else 'FAIL'}"
             for k in cell.limits if k in worst]
    return result, lines


def main(argv, t_start: float, root: Path) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result, lines = measure(root, args.workload, args.seed, args.seconds,
                                bool(args.trace), t_start)
    except HarnessError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for ln in lines:
        print(ln, file=sys.stderr)
    return 0
