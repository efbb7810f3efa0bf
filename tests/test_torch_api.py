"""The face-grid layout conversions of methods/cells_last.py (row-major
GridVec <-> cells-last GridVecCL) against the JAX functions on the CPU,
float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proton_tpu.methods import cells_last as jcl, structured as jstructured
from proton_tpu_torch.methods import cells_last, structured

CPU = torch.device("cpu")


def _close(a, ref, tol=1e-12):
    ref = np.asarray(ref)
    assert np.asarray(a).shape == ref.shape
    assert np.max(np.abs(np.asarray(a) - ref)) <= tol * np.max(np.abs(ref))


@pytest.mark.parametrize("fbs", [1, 2])
def test_grid_layout_conversions_match(fbs):
    """to_cells_last and from_cells_last against JAX on a 7 x 5 face
    grid; the round trip is the identity."""
    Nx, Ny = 7, 5
    rng = np.random.default_rng(fbs)
    H = rng.standard_normal((Ny + 1, Nx, fbs))
    V = rng.standard_normal((Ny, Nx + 1, fbs))
    jx = jcl.to_cells_last(jstructured.GridVec(jnp.asarray(H),
                                               jnp.asarray(V)))
    x = cells_last.to_cells_last(structured.GridVec(torch.as_tensor(H),
                                                    torch.as_tensor(V)))
    for a, b in zip(x, jx):
        _close(a.numpy(), b, 0.0)
    back = cells_last.from_cells_last(x)
    assert isinstance(back, structured.GridVec)
    for a, b in zip(back, jcl.from_cells_last(jx)):
        _close(a.numpy(), b, 0.0)
    _close(back.H.numpy(), H, 0.0)
    _close(back.V.numpy(), V, 0.0)
