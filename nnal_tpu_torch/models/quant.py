"""Post-training int8 quantization for serving (counterpart of
``nnal_tpu/models/quant.py``).

Weights: static symmetric per-output-channel int8, ``W_q = rint(W / s_w)``
clipped to +-127 with ``s_w[oc] = max(max|W[..., oc]| / 127, 1e-12)``,
computed in numpy on the JAX-layout tree exactly as the JAX package does,
so ``W_q`` and ``w_scale`` are bit-equal to its.  Activations: dynamic
symmetric per-tensor int8 inside each quantized layer
(``models/cnn._quantize_act``).  ``convT`` layers stay float (as in JAX),
and so does any layer named in ``keep_float``.

:func:`quantize_params` returns the JAX-layout tree variant (``W``
replaced by ``W_q`` + ``w_scale``; it saves and loads through
``models/checkpoint`` with its int8 and f32 leaves exact), and
:func:`quantized_cnn` builds the :class:`~nnal_tpu_torch.models.cnn.CNN`
that serves it: each quantized conv or fc module holds ``W_q`` (OIHW or
(out, in), int8) and ``w_scale`` as buffers in place of its ``weight``
parameter, and its forward takes the int8 branch.  Serving only: the
rounding has no gradient, so training and FIM scoring keep float models.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from nnal_tpu_torch.core.device import resolve_device
from nnal_tpu_torch.models.bridge import from_jax_params, to_jax_params
from nnal_tpu_torch.models.cnn import CNN

__all__ = ["quantize_params", "is_quantized", "quantized_cnn",
           "quantize_model"]


def _per_out_channel_scale(W: np.ndarray) -> np.ndarray:
    """max|W| over all axes but the last (the output channel), / 127 in
    float64 then floored and rounded to f32, as ``quant.py:45-50``."""
    absmax = np.max(np.abs(W), axis=tuple(range(W.ndim - 1)))
    return np.maximum(absmax / 127.0, 1e-12).astype(np.float32)


def quantize_params(spec, params, keep_float: Sequence[str] = ()) -> Dict:
    """int8 variant of a JAX-layout ``{layer: {"W", "b", ...}}`` tree
    (``quant.py:53-73``): conv and fc layers get ``{"W_q": int8,
    "w_scale": (out,) f32, "b", ...}``; ``convT``, layers in
    ``keep_float`` and weightless layers pass through.  numpy leaves."""
    kinds = {layer.name: layer.kind for layer in spec.layers}
    out: Dict = {}
    for name, p in params.items():
        if (kinds.get(name) in ("conv", "fc") and "W" in p
                and name not in keep_float):
            W = np.asarray(p["W"], np.float32)
            s_w = _per_out_channel_scale(W)
            W_q = np.clip(np.rint(W / s_w), -127, 127).astype(np.int8)
            q = {"W_q": W_q, "w_scale": s_w}
            q.update({k: np.asarray(v) for k, v in p.items() if k != "W"})
            out[name] = q
        else:
            out[name] = {k: np.asarray(v) for k, v in p.items()}
    return out


def is_quantized(params) -> bool:
    """True for a quantized JAX-layout tree or a :class:`CNN` that holds
    int8 layers."""
    if isinstance(params, torch.nn.Module):
        return any(name.endswith("W_q") for name, _ in params.named_buffers())
    return any("W_q" in p for p in params.values())


def quantized_cnn(spec, qparams, device=None) -> CNN:
    """The :class:`CNN` of ``spec`` serving the quantized tree ``qparams``
    (from :func:`quantize_params` or a checkpoint), on ``device`` (None:
    the card)."""
    device = resolve_device(device)
    model = CNN(spec)
    for name, p in qparams.items():
        if "W_q" not in p:
            continue
        mod = getattr(model, name)
        shape = mod.weight.shape
        del mod.weight
        mod.register_buffer("W_q", torch.zeros(shape, dtype=torch.int8))
        mod.register_buffer("w_scale", torch.zeros(shape[0]))
    model.load_state_dict(from_jax_params(qparams))
    return model.to(device)


def quantize_model(model: CNN, keep_float: Sequence[str] = ()) -> CNN:
    """A quantized copy of a float :class:`CNN`, on its device."""
    dev = next(model.parameters()).device
    qp = quantize_params(model.spec, to_jax_params(model.state_dict()),
                         keep_float)
    return quantized_cnn(model.spec, qp, device=dev)
