"""Checkpoint / resume of the obstacle active-set loop (JAX counterpart:
proton_tpu/utils/checkpoint.py). The reference keeps only per-iteration
SILO field dumps (obstacle.cpp); these are restartable snapshots: plain
npz files of named arrays."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch


def save_state(filename: str, **arrays):
    """Save named arrays atomically (write, then rename)."""
    tmp = filename + ".tmp.npz"
    np.savez(tmp, **{k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                     else np.asarray(v) for k, v in arrays.items()})
    os.replace(tmp, filename)


def load_state(filename: str) -> Dict[str, np.ndarray]:
    """The arrays of a snapshot, as numpy (the caller places them)."""
    with np.load(filename) as data:
        return {k: data[k] for k in data.files}


def obstacle_checkpoint(filename: str, alpha_cells, beta, iteration: int):
    """Snapshot of the obstacle active-set state."""
    save_state(filename, alpha_cells=alpha_cells, beta=beta,
               iteration=np.int64(iteration))


def obstacle_resume(filename: str):
    """(alpha_cells, beta, iteration) of a snapshot; the arrays as numpy,
    ready for solve_obstacle's ``initial_state``."""
    s = load_state(filename)
    return s["alpha_cells"], s["beta"], int(s["iteration"])
