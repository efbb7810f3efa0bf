"""Gnuplot point-cloud outputs (JAX counterpart: proton_tpu/io/gnuplot.py;
reference postprocess_output / gnuplot_output_object,
cuthho_square.cpp:737-804): rows of "x y value" written from the host,
whole batches at a time."""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


class GnuplotOutput:
    """Buffers (point, value) rows and writes them to a .dat file."""

    def __init__(self, filename: str):
        self.filename = filename
        self._pts = []
        self._vals = []

    def add_data(self, pts, vals):
        """pts [..., 2], vals [...]: whole batches at once."""
        self._pts.append(_host(pts).reshape(-1, 2))
        self._vals.append(_host(vals).reshape(-1))

    def write(self) -> bool:
        pts = np.concatenate(self._pts) if self._pts else np.zeros((0, 2))
        vals = np.concatenate(self._vals) if self._vals else np.zeros((0,))
        with open(self.filename, "w") as fh:
            for (x, y), v in zip(pts, vals):
                fh.write(f"{x} {y} {v}\n")
        return True


class PostprocessOutput:
    """Writes every registered output (postprocess_output,
    cuthho_square.cpp:783-804)."""

    def __init__(self):
        self._objects = []

    def add_object(self, obj):
        self._objects.append(obj)

    def write(self) -> bool:
        for obj in self._objects:
            obj.write()
        return True
