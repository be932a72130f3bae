"""Device and precision policy — the counterpart of ``nnal_tpu/core/platform.py``.

Entry points run on the card unless the caller asks for the CPU: a missing
CUDA device is an error that names ``device="cpu"``, never a silent drop to
the host.  The slice computes in IEEE float32, so TF32 is switched off for
both matrix products and cuDNN convolutions (cuDNN defaults to TF32, which
keeps about three decimal digits and cannot meet the f32 parity oracles).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is requested but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device=\"cpu\" (or --device cpu) "
            "to run the port on the host")
    return dev


def set_precision() -> None:
    """IEEE float32 everywhere: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def synchronize(device) -> None:
    """Wait for queued kernels on a CUDA device (no-op on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
