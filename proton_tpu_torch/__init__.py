"""PyTorch / CUDA port of proton_tpu for the NVIDIA H100 (JAX
counterpart: the ``proton_tpu`` package beside it).

It holds the cutHHO fictitious-domain solve on the generated mesh
(``cut.fictdom_structured.solve_fictdom_structured``: the lean system with
the multigrid V-cycle by default, kernel K1 for the fitted operators) and
the uncut HHO path on quad and polygonal meshes (``methods.poisson``,
``methods.condensation``, ``methods.obstacle`` and the ``apps``).
"""

from . import config  # noqa: F401,E402  (switches TF32 off on import)
