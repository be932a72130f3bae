"""Device and precision policy — the counterpart of ``nnal_tpu/core/platform.py``.

Entry points run on the card unless the caller asks for the CPU: a missing
CUDA device is an error that names ``device="cpu"``, never a silent drop to
the host.  The f32 path computes in IEEE float32, so TF32 is switched off
for both matrix products and cuDNN convolutions (cuDNN defaults to TF32,
which keeps about three decimal digits and cannot meet the f32 parity
oracles).  The bf16 path (``model.dtype`` / ``train_dtype`` bfloat16)
accumulates in f32, as the JAX package's ``preferred_element_type=f32``
asks: cuBLAS may not reduce in bf16 inside a split-K GEMM.
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
    """IEEE float32 everywhere (no TF32 in matmuls or convolutions) and
    f32 accumulation for bf16 GEMMs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms (no atomics in the
    weight-gradient convolutions), for the finetune: crash-resume replays
    finetunes and promises bit-identical state.  ``flags()`` defaults
    ``enabled`` to False and ``allow_tf32`` to True, so both are passed."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def synchronize(device) -> None:
    """Wait for queued kernels on a CUDA device (no-op on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
