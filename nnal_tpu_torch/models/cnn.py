"""CNN engine over a :class:`CNNSpec` (counterpart of ``nnal_tpu/models/cnn.py``).

``CNN`` is an ``nn.Module`` built from the same spec rows as the JAX
package's ``init_cnn``/``apply_cnn``.  This slice supports the
conv/pool/fc stacks without batch norm or skip connections (PW1, and the
VGG/AlexNet shapes), with or without the aleatoric head; dense (fcn)
specs and BN raise.

Semantics kept from the JAX package:
* public inputs are channels-last ``(b, d1, d2, C)``; internally the module
  runs NCHW (``forward(..., nchw=True)`` skips the transpose);
* ``SAME`` convolution and max-pool padding is XLA's: ``total = max((out-1)
  * s + k - n, 0)``, ``lo = total // 2`` — for the 2x2 stride-2 pools on
  odd sizes (25 -> 13 -> 7) that is one ``-inf`` row/column at the END
  only;
* fc layers flatten in (h, w, c) order, so the activation is permuted to
  channels-last before the first fc;
* dropout (drop probability) follows every layer with ``dropout > 0`` —
  for PW1 fc1, fc2 and the linear head fc3 — when ``train`` or
  ``mc_dropout`` (dropout alone, for MC-dropout scoring passes,
  ``cnn.py:181-193``) and a generator are given; ``feature`` is the
  feature layer's output after it.  The mask is JAX's ``bernoulli``:
  ``u < keep`` for ``u`` uniform in f32 and ``keep = 1 - rate``, then
  ``where(mask, h / keep, 0)`` at ``h``'s dtype (bf16 on bf16 sweeps).
  The uniforms come from :func:`_dropout_uniform`, the one place they are
  drawn;
* the compute dtype is the input's (``apply_cnn(compute_dtype=...)`` casts
  the input, ``cnn.py:193-194``).  A bf16 input runs every conv and fc on
  bf16 operands (weights and biases cast per call) with an f32 result, adds
  the bias in f32 and rounds once to bf16 (``_main_op``, ``cnn.py:329-367``);
  activations, max-pool and dropout run in bf16, and the logits are upcast
  to f32 before softmax and argmax (``cnn.py:247``);
* an aleatoric spec (``specs.with_aleatoric_head``) doubles the last
  layer: its output splits into ``logits`` (the first ``nclass``
  columns, which the posteriors and the prediction read) and
  ``log_sigma`` (the rest, at the compute dtype), as
  ``cnn.py:243-252`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nnal_tpu_torch.core.device import resolve_device
from nnal_tpu_torch.models.specs import CNNSpec


@dataclass
class CNNOutput:
    logits: torch.Tensor
    posteriors: torch.Tensor
    prediction: torch.Tensor
    feature: Optional[torch.Tensor]
    log_sigma: Optional[torch.Tensor] = None   # the aleatoric head


_ACTS = {"relu": F.relu, "elu": F.elu, "tanh": torch.tanh, "gelu": F.gelu,
         "identity": lambda x: x}


def conv2d_f32acc(h, W, stride, padding) -> torch.Tensor:
    """``conv(h, W)`` of same-dtype low-precision operands with an f32
    result — ``make_conv_f32acc`` (``cnn.py:265-300``).  That custom VJP
    exists only to make JAX's transpose legal; here the backward is
    autograd's, and it gets a bf16 cotangent as that VJP arranges.  On the
    host the operands are upcast: bf16 x bf16 products are exact in f32,
    so this is f32 accumulation rounded once, the JAX semantics.  On the
    card cuDNN runs bf16 on the tensor cores with f32 accumulation and
    returns bf16, so the sum is rounded before the caller adds its bias
    (a second rounding; ROADMAP Queue 3)."""
    if h.device.type == "cuda":
        return F.conv2d(h, W, None, stride, padding).float()
    return F.conv2d(h.float(), W.float(), None, stride, padding)


class _MmF32Acc(torch.autograd.Function):
    """``torch.mm(h, W.T, out_dtype=f32)`` — bf16 operands, cuBLAS's f32
    accumulator written out, one rounding fewer than a bf16 GEMM plus an
    f32 bias — with the backward that op lacks in torch 2.11.  The
    cotangent is cast to the operands' dtype first, as ``make_conv_f32acc``
    does (``cnn.py:294-297``), then each gradient is one bf16 GEMM; only
    the gradients autograd asks for are formed."""

    @staticmethod
    def forward(ctx, h, W):
        ctx.save_for_backward(h, W)
        return torch.mm(h, W.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, W = ctx.saved_tensors
        g = g.to(h.dtype)
        gh = g @ W if ctx.needs_input_grad[0] else None
        gW = g.t() @ h if ctx.needs_input_grad[1] else None
        return gh, gW


def linear_f32acc(h, W) -> torch.Tensor:
    """``h @ W.T`` of same-dtype low-precision operands with an f32 result
    (``jnp.dot(..., preferred_element_type=f32)``): on the card through
    :class:`_MmF32Acc`, on the host by upcasting, as in
    :func:`conv2d_f32acc`."""
    if h.device.type == "cuda":
        return _MmF32Acc.apply(h, W)
    return h.float() @ W.float().t()


def _conv_dim(n, k, s, padding):
    if padding == "SAME":
        return -(-n // s)
    return -(-(n - k + 1) // s)


def _same_pad(n, k, s) -> Tuple[int, int]:
    total = max((_conv_dim(n, k, s, "SAME") - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _check_supported(spec: CNNSpec) -> None:
    if spec.fcn:
        raise NotImplementedError("model: dense (fcn) specs are not ported")
    if spec.spatial_rank != 2:
        raise NotImplementedError("model: only 2-D conv specs are ported")
    for layer in spec.layers:
        if layer.kind not in ("conv", "pool", "fc"):
            raise NotImplementedError(f"model: layer kind {layer.kind!r}")
        if layer.sources or "B" in layer.op_order:
            raise NotImplementedError(
                f"model: layer {layer.name!r} uses skip sources or batch "
                "norm, which are not ported")


def _dropout_uniform(shape, generator: torch.Generator, device,
                     layer_index: int) -> torch.Tensor:
    """The f32 uniforms of one dropout mask, drawn from ``generator`` in
    layer order.  ``layer_index`` is the spec row, the tag JAX folds into
    its dropout key (``fold_in(key, i)``, ``cnn.py:230``); the port's own
    stream does not need it, a test that feeds JAX's draws does."""
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


class CNN(nn.Module):
    """Sequential conv/pool/fc network; submodules are named after the spec
    rows (``conv1``, ``fc1``, ...) so ``state_dict`` keys are
    ``<layer>.weight`` / ``<layer>.bias``."""

    def __init__(self, spec: CNNSpec):
        super().__init__()
        _check_supported(spec)
        self.spec = spec
        self.act = _ACTS[spec.activation]
        self._pads: Dict[str, Tuple[int, int, int, int]] = {}
        h, w, c = spec.input_shape
        for layer in spec.layers:
            if layer.kind == "conv":
                (kh, kw), (sh, sw) = layer.ksize, layer.strides
                sym = (0, 0)
                if layer.padding == "SAME":
                    ph, pw = _same_pad(h, kh, sh), _same_pad(w, kw, sw)
                    if ph[0] == ph[1] and pw[0] == pw[1]:
                        sym = (ph[0], pw[0])      # odd kernels, stride 1
                    else:
                        self._pads[layer.name] = (pw[0], pw[1], ph[0], ph[1])
                self.add_module(layer.name, nn.Conv2d(
                    c, layer.out, (kh, kw), (sh, sw), padding=sym))
                h = _conv_dim(h, kh, sh, layer.padding)
                w = _conv_dim(w, kw, sw, layer.padding)
                c = layer.out
            elif layer.kind == "pool":
                (kh, kw), (sh, sw) = layer.ksize, layer.strides
                ph, pw = _same_pad(h, kh, sh), _same_pad(w, kw, sw)
                self._pads[layer.name] = (pw[0], pw[1], ph[0], ph[1])
                h = _conv_dim(h, kh, sh, "SAME")
                w = _conv_dim(w, kw, sw, "SAME")
            else:
                in_d = h * w * c
                self.add_module(layer.name, nn.Linear(in_d, layer.out))
                h, w, c = 1, 1, layer.out

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                nchw: bool = False, mc_dropout: bool = False) -> CNNOutput:
        h = x if nchw else x.permute(0, 3, 1, 2)
        dt = h.dtype
        flat = False
        feature = None
        use_dropout = (train or mc_dropout) and generator is not None
        for i, layer in enumerate(self.spec.layers):
            mod = getattr(self, layer.name, None)
            if layer.kind == "conv":
                pad = self._pads.get(layer.name)
                if pad is not None:
                    h = F.pad(h, pad)
                if dt == torch.float32:
                    h = mod(h)
                else:
                    h = (conv2d_f32acc(h, mod.weight.to(dt), mod.stride,
                                       mod.padding)
                         + mod.bias.to(dt)[:, None, None]).to(dt)
            elif layer.kind == "pool":
                h = F.pad(h, self._pads[layer.name], value=float("-inf"))
                h = F.max_pool2d(h, layer.ksize, layer.strides)
            else:
                if not flat:
                    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
                    flat = True
                if dt == torch.float32:
                    h = mod(h)
                else:
                    h = (linear_f32acc(h, mod.weight.to(dt))
                         + mod.bias.to(dt)).to(dt)
            if layer.kind != "pool" and "A" in layer.op_order:
                h = self.act(h)
            if layer.dropout > 0 and use_dropout:
                keep = 1.0 - layer.dropout
                mask = _dropout_uniform(h.shape, generator, h.device,
                                        i) < keep
                # a tensor divisor at h's dtype: JAX divides by the weakly
                # typed keep rounded to h's dtype, and torch would turn a
                # Python-scalar divisor into a reciprocal multiply
                div = h.new_full((), keep)
                h = torch.where(mask, h / div, torch.zeros_like(h))
            if i == self.spec.feature_layer:
                feature = h.reshape(h.shape[0], -1)
        log_sigma = None
        if self.spec.aleatoric:
            h, log_sigma = h.chunk(2, dim=-1)
        logits = h.float()
        return CNNOutput(logits=logits,
                         posteriors=torch.softmax(logits, dim=-1),
                         prediction=torch.argmax(logits, dim=-1),
                         feature=feature, log_sigma=log_sigma)


def init_cnn(spec: CNNSpec, seed: int, device=None) -> CNN:
    """He-initialized network (``cnn.py:55-92``): weights ~ N(0, 2/fan_in),
    zero biases, drawn from a ``torch.Generator`` seeded with ``seed`` on
    the host, then moved to ``device`` (``None``: the card)."""
    device = resolve_device(device)
    model = CNN(spec)
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for mod in model.children():
            fan_in = int(np.prod(mod.weight.shape[1:]))
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                             * np.sqrt(2.0 / fan_in))
            mod.bias.zero_()
    return model.to(device)

