"""PyTorch / CUDA port of proton_tpu for the NVIDIA H100 (JAX
counterpart: the ``proton_tpu`` package beside it).

Slice 1 holds the cutHHO fictitious-domain solve on the generated mesh
with the fitted="full" operators and block-Jacobi or Jacobi PCG:
``proton_tpu_torch.cut.fictdom_structured.solve_fictdom_structured``.
"""

from . import config  # noqa: F401,E402  (switches TF32 off on import)
