"""Dtype, device resolution and matmul precision for proton_tpu_torch
(JAX counterpart: proton_tpu/config.py).

The reference is a float64 code, and the H100 has native float64, so the
port works in ``torch.float64`` throughout. Torch's default dtype is
float32: every entry point takes an explicit ``dtype`` that defaults to
:data:`DEFAULT_DTYPE`.

TF32 is switched off for both cuBLAS matmuls and cuDNN convolutions, and
float32 matmuls run at the "highest" precision: the counterpart of the
JAX package pinning ``Precision.HIGHEST`` for its float32 contractions.
The precision modes (cut/fictdom_structured.py: ``mixed``, ``mg_f32``)
run the system or the V-cycle in float32, and a reduced-precision
product there floors the outer CG, as the TPU's default precision did.

Entry points run on CUDA unless the caller asks for ``device="cpu"``.
Without a device and without CUDA they raise: they never carry on on the
CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DTYPE = torch.float64

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else CUDA.
    Raises when no device is given and CUDA is absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "proton_tpu_torch runs on CUDA unless device='cpu' is "
                "passed, and no CUDA device is available")
        return torch.device("cuda")
    return torch.device(device)


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
