"""The one traffic generator: the problems of a run, from a traffic file
and the run's seed.

A traffic file is JSON with ``driver`` (the file under ``drivers/`` that
runs a problem), ``geometry`` and ``pool``:

- ``geometry`` = ``{"shape": "circle", "radius": [lo, hi], "center":
  [x, y], "offset_cells": a}``: a circle whose radius is uniform on
  [lo, hi] and whose centre is (x, y) plus an offset uniform on
  [-a h, a h]^2, h = 1 / N the configuration's mesh spacing;
- ``pool`` = ``{"size": P, "seed": s}``: the P problems of every run,
  drawn by that law from ``numpy.random.Generator(s)`` in the order
  radius, offset x, offset y, problem after problem.

The run's seed orders the pool: a round is a permutation of it, then
comes another, for as long as the window asks. Every seed gets the same
set of problems, and the window ends only at the end of a round, so the
seed moves the order and not the work.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np


def rng(seed: int) -> np.random.Generator:
    """The seed's generator; any whole number, negative ones too."""
    return np.random.default_rng(seed % 2 ** 64)


def pool(traffic: dict, config: dict) -> List[dict]:
    g, p = traffic["geometry"], traffic["pool"]
    if g["shape"] != "circle":
        raise ValueError(f"unknown geometry shape {g['shape']!r}")
    lo, hi = g["radius"]
    cx, cy = g["center"]
    a = g["offset_cells"] / config["N"]
    r = rng(p["seed"])
    out = []
    for _ in range(p["size"]):
        radius = float(r.uniform(lo, hi))
        dx, dy = (float(v) for v in r.uniform(-a, a, size=2))
        out.append({"radius": radius, "center": [cx + dx, cy + dy]})
    return out


def problems(traffic: dict, config: dict,
             seed: int) -> Iterator[Tuple[dict, bool]]:
    """(problem, whether it ends a round of the pool), endlessly."""
    items = pool(traffic, config)
    r = rng(seed)
    while True:
        order = r.permutation(len(items))
        for n, i in enumerate(order, 1):
            yield items[i], n == len(order)
