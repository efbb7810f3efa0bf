"""Readings for the limits of a cell's comparison: the numbers the judge
compares, from the program as the benchmark runs it ("sound") and from
the control, the program run with the options its driver declares as
``CONTROL`` (for ``drivers/solve.py``: ``mixed=True``, the stored
system, the V-cycle and the recovery in float32 around a float64 CG, the
JAX package's default on the TPU). Each seed draws one problem by the
cell's traffic law, as a pool of one with that seed, so the readings
cover more geometries than the cell's pool. One JSON line per problem.
Not part of any benchmark run:

    python3 benchmark/readings.py --workload cuthho_1024_k1.solve \
        --sound-seeds 1 2 3 --control-seeds 4 5 6

Run on the card from the root of a checkout.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(root: Path, workload: str, sound_seeds, control_seeds,
             device=None):
    """One record per seed, sound seeds first. ``device`` is the cell's
    first card unless given (the CPU tests give it)."""
    from benchmark import harness
    cell = harness.load_cell(root, workload)
    if device is None:
        device = harness.require_cards(cell.chips)
    driver = cell.driver()
    generator = cell.generator()
    driver.warm(cell.config, device)
    runs = [(s, "sound", {}) for s in sound_seeds] + \
        [(s, "control", driver.CONTROL) for s in control_seeds]
    for seed, kind, options in runs:
        law = dict(cell.traffic, pool={"size": 1, "seed": seed})
        params = generator.pool(law, cell.config)[0]
        t0 = time.perf_counter()
        try:
            outcome = driver.run(cell.config, params, device, **options)
        except Exception as e:  # a control that crashes has failed
            yield {"seed": seed, "kind": kind, "error": repr(e)}
            continue
        harness._sync(device)
        seconds = time.perf_counter() - t0
        driver.release(device)
        t1 = time.perf_counter()
        numbers = driver.judge(cell.config, params, outcome, device)
        yield {
            "seed": seed, "kind": kind, "params": params,
            "seconds": seconds, "judge_s": time.perf_counter() - t1,
            "iterations": outcome.iterations, "exit": outcome.exit_reason,
            "program_h1": outcome.h1_error,
            "rel_residual": outcome.rel_residual, **numbers,
            "timings": outcome.timings}


def main(argv) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    for record in readings(Path(ROOT), args.workload, args.sound_seeds,
                           args.control_seeds):
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(sys.argv[1:])
