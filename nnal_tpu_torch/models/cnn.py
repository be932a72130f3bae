"""CNN engine over a :class:`CNNSpec` (counterpart of ``nnal_tpu/models/cnn.py``).

``CNN`` is an ``nn.Module`` built from the same spec rows as the JAX
package's ``init_cnn``/``apply_cnn``: 2-D conv, transposed-conv, max- and
average-pool and fc layers in any ``op_order`` of main op (``M``), batch
norm (``B``) and activation (``A``), with skip ``sources`` combined by
``concat`` or ``sum`` (PW1, the VGG/AlexNet shapes, DenseNet2B and the
dense FC-DenseNet-103 "Tiramisu"), with or without the aleatoric head.
3-D (rank-3) specs raise.

Semantics kept from the JAX package:
* public inputs are channels-last ``(b, d1, d2, C)``; internally the module
  runs NCHW (``forward(..., nchw=True)`` skips the transpose);
* ``SAME`` convolution and pool padding is XLA's: ``total = max((out-1)
  * s + k - n, 0)``, ``lo = total // 2`` — for the 2x2 stride-2 pools on
  odd sizes (25 -> 13 -> 7) that is one ``-inf`` row/column at the END
  only.  It is worked out from each call's own spatial size, so a fully
  convolutional (fcn) spec runs on slices of any size, as in JAX;
* a transposed conv is ``lax.conv_transpose(h, W, strides, padding)``
  (``cnn.py:346-350``): the input dilated by the stride, padded ``(a,
  b)`` by XLA's transpose rule (``(2, 1)`` for 3x3 stride 2 SAME) and
  convolved with the UNflipped kernel.  That is ``conv_transpose2d`` with
  the kernel flipped, cropped to ``[k-1-a, k-1-a + out)``.  Its weight is
  held in the conv layout ``(out, in, kh, kw)`` (the JAX kernel's HWIO
  transposed like a conv's), so the bridge, the anchors' per-output int8
  axis and the optimizer's moments treat it as any conv weight; the
  forward transposes and flips it;
* skip sources are center-cropped to the smallest spatial size before a
  ``concat`` (``cnn.py:159-169``, ``:203-215``); a ``sum`` crops the later
  sources to the first's;
* batch norm (``_batch_norm``, ``cnn.py:371-394``) sits before or after the
  main op by ``op_order`` (``_bn_width``); it normalizes with eps 1e-3 by
  the BIASED batch statistics when ``train`` is set or no running state is
  given, else by the state's running mean and variance, and with ``train``
  and a state it returns the state moved toward the batch statistics at
  ``bn_decay`` (f32).  The statistics are computed explicitly, not by
  ``F.batch_norm``, whose running variance is the unbiased one and whose
  eps is 1e-5.  ``gamma`` / ``beta`` are parameters of the layer's module
  (``<layer>.gamma``), the running state a separate ``{layer: {"mean",
  "var"}}`` dict, as the JAX package keeps it;
* fc layers flatten in (h, w, c) order, so the activation is permuted to
  channels-last before the first fc;
* dropout (drop probability) follows every layer with ``dropout > 0`` —
  for PW1 fc1, fc2 and the linear head fc3, for the Tiramisu every dense
  block and transition conv — when ``train`` or ``mc_dropout`` (dropout
  alone, for MC-dropout scoring passes, ``cnn.py:181-193``) and a
  generator are given; ``feature`` is the feature layer's output after it
  (flattened channels-last, or for an fcn spec the per-pixel ``(b, H, W,
  C)`` map).  The mask is JAX's ``bernoulli``: ``u < keep`` for ``u``
  uniform in f32 over the channels-last shape and ``keep = 1 - rate``,
  then ``where(mask, h / keep, 0)`` at ``h``'s dtype (bf16 on bf16
  sweeps).  The uniforms come from :func:`_dropout_uniform`, the one place
  they are drawn;
* the compute dtype is the input's (``apply_cnn(compute_dtype=...)`` casts
  the input, ``cnn.py:193-194``).  A bf16 input runs every conv and fc on
  bf16 operands (weights and biases cast per call) with an f32 result, adds
  the bias in f32 and rounds once to bf16 (``_main_op``, ``cnn.py:329-367``);
  a transposed conv runs in bf16 and adds a bf16 bias, batch norm,
  activations, pools and dropout run in bf16, and the logits are upcast to
  f32 before softmax and argmax (``cnn.py:247``); a float64 input (the
  reference steps of ``chip_smoke.py``) runs every op at float64;
* an aleatoric spec (``specs.with_aleatoric_head``) doubles the last
  layer: its output splits into ``logits`` (the first ``nclass``
  columns, which the posteriors and the prediction read) and
  ``log_sigma`` (the rest, at the compute dtype), as
  ``cnn.py:243-252`` does.  An fcn spec's logits, posteriors and
  prediction are per pixel, channels-last;
* a conv or fc module that holds an int8 ``W_q`` buffer and an f32
  per-output ``w_scale`` in place of its ``weight`` (``models/quant``)
  runs the int8 branch (``_int8_main``, ``cnn.py:301-331``): the layer
  input is quantized per tensor (:func:`_quantize_act`), a conv's is
  unfolded (im2col of the int8 codes, at the module's and ``pad_input``'s
  SAME padding), and the int8 x int8 products are summed in int32 by
  :func:`int8_matmul` (``torch._int_mm`` on the card, exact integer sums
  through f32 GEMMs on the host); the accumulator is rescaled by ``s_x *
  w_scale`` and the bias added as one fused multiply-add, as the jitted
  XLA program computes it, then rounded to the incoming dtype (under
  bf16 the bias is rounded to bf16 first, as ``cast_float_params`` does).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from nnal_tpu_torch.core.device import resolve_device
from nnal_tpu_torch.models.specs import CNNSpec


@dataclass
class CNNOutput:
    logits: torch.Tensor
    posteriors: torch.Tensor
    prediction: torch.Tensor
    feature: Optional[torch.Tensor]
    log_sigma: Optional[torch.Tensor] = None   # the aleatoric head
    state: Optional[Dict] = None               # BN running stats (``state=``)
    probes: Optional[Dict[str, torch.Tensor]] = None  # ``keep_probes=True``


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


# 1/127 in f32: XLA folds the jitted ``max|h| / 127.0`` of
# ``_quantize_act`` into a multiply by this constant, and the evaluators
# run it jitted
_INV127 = float(np.float32(1.0) / np.float32(127.0))
# bytes of int8 columns, int32 and float64 partial results per row chunk
_INT8_CHUNK_BYTES = 1 << 29


def _quantize_act(h: torch.Tensor):
    """Dynamic symmetric per-tensor int8 (``cnn.py:301-307``): ``s_x =
    max(max|h|, 1e-12) * f32(1/127)`` and ``q = clip(round(h / s_x),
    +-127)`` (round half to even), in f32 whatever ``h``'s dtype.  ``s_x``
    stays a device tensor, so the division is a true one on the card too
    (a host-scalar divisor becomes a reciprocal multiply there)."""
    h32 = h.float()
    s_x = torch.clamp_min(h32.abs().amax(), 1e-12) * _INV127
    q = torch.clamp(torch.round(h32 / s_x), -127, 127).to(torch.int8)
    return q, s_x


# f32 sums of at most this many int8 x int8 products are exact integers
# (127^2 * 1024 < 2^24)
_EXACT_F32_K = 1024


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` of int8 ``a`` (m, k) and ``w`` (n, k), summed exactly in
    int32, as XLA's int32 accumulator.  On the card ``torch._int_mm``
    (cuBLASLt's int8 GEMM), which wants m > 16 and k, n multiples of 8:
    the operands are zero-padded to that, which adds zeros to the sums,
    and the output is sliced back.  On the host (the plain version) the
    codes go through f32 GEMMs over k-slices of at most 1,024, whose every
    partial sum is an integer below 2^24 and so exact, added in int32:
    the same integers, at BLAS speed (an int32 ``torch.mm`` has no BLAS
    path and is ~10x slower)."""
    if a.device.type != "cuda":
        a32, w32 = a.float(), w.float()
        out = None
        for k0 in range(0, a.shape[1], _EXACT_F32_K):
            part = torch.mm(a32[:, k0:k0 + _EXACT_F32_K],
                            w32[:, k0:k0 + _EXACT_F32_K].t()).to(torch.int32)
            out = part if out is None else out + part
        return out
    m, k = a.shape
    n = w.shape[0]
    pad_k, pad_n, pad_m = -k % 8, -n % 8, max(17 - m, 0)
    if pad_k or pad_m:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        w = F.pad(w, (0, pad_k, 0, pad_n))
    return torch._int_mm(a.contiguous(), w.contiguous().t())[:m, :n]


def _rescale_int8(acc, s_x, w_scale, bias, dt) -> torch.Tensor:
    """``acc * (s_x * w_scale) + b`` rounded once to f32, then to ``dt``.
    XLA fuses the multiply and the bias add of ``_int8_main`` into one
    fused multiply-add; here the f32 accumulator value times the f32 scale
    is exact in float64, so a float64 add rounded to f32 is that FMA (up
    to a double rounding of probability ~2^-29 a value)."""
    scale = (s_x * w_scale).double()
    y = acc.float().double() * scale + bias.double()
    return y.float().to(dt)


def _int8_main(layer, mod, h: torch.Tensor, dt) -> torch.Tensor:
    """The int8 branch of a quantized conv (NCHW ``h``, already padded by
    ``pad_input`` where the module does not pad itself) or fc layer, in
    row chunks of about ``_INT8_CHUNK_BYTES``.  Its parts run under
    ``int8/quantize``, ``int8/im2col``, ``int8/int_mm`` and
    ``int8/rescale`` profiler ranges (a profile of a sweep splits its
    device time by them)."""
    bias = mod.bias.to(dt)
    if layer.kind == "fc" and h.dim() > 2:
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    with record_function("int8/quantize"):
        q, s_x = _quantize_act(h)
    wmat = mod.W_q.reshape(mod.W_q.shape[0], -1)
    n_out, k = wmat.shape
    if layer.kind == "fc":
        step = max(1, _INT8_CHUNK_BYTES // (k + 12 * n_out))
        outs = []
        for lo in range(0, q.shape[0], step):
            with record_function("int8/int_mm"):
                acc = int8_matmul(q[lo:lo + step], wmat)
            with record_function("int8/rescale"):
                outs.append(_rescale_int8(acc, s_x, mod.w_scale, bias, dt))
        return torch.cat(outs) if len(outs) > 1 else outs[0]
    ph, pw = mod.padding
    (kh, kw), (sh, sw) = layer.ksize, layer.strides
    b, _, hh, ww = q.shape
    ho = (hh + 2 * ph - kh) // sh + 1
    wo = (ww + 2 * pw - kw) // sw + 1
    step = max(1, _INT8_CHUNK_BYTES // (ho * wo * (k + 12 * n_out)))
    outs = []
    for lo in range(0, b, step):
        with record_function("int8/im2col"):
            blk = q[lo:lo + step]
            if ph or pw:
                blk = F.pad(blk, (pw, pw, ph, ph))
            cols = blk.unfold(2, kh, sh).unfold(3, kw, sw).permute(
                0, 2, 3, 1, 4, 5).reshape(-1, k)    # (c, kh, kw) features
        with record_function("int8/int_mm"):
            acc = int8_matmul(cols, wmat)
        with record_function("int8/rescale"):
            y = _rescale_int8(acc, s_x, mod.w_scale, bias, dt)
        outs.append(y.reshape(blk.shape[0], ho, wo, n_out).permute(
            0, 3, 1, 2))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _conv_dim(n, k, s, padding):
    if padding == "SAME":
        return -(-n // s)
    return -(-(n - k + 1) // s)


def _same_pad(n, k, s) -> Tuple[int, int]:
    total = max((_conv_dim(n, k, s, "SAME") - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pads_for(layer, hw) -> Tuple[int, int, int, int]:
    """``F.pad`` widths (w_lo, w_hi, h_lo, h_hi) of a SAME layer on
    spatial size ``hw``."""
    (kh, kw), (sh, sw) = layer.ksize, layer.strides
    ph, pw = _same_pad(hw[0], kh, sh), _same_pad(hw[1], kw, sw)
    return (pw[0], pw[1], ph[0], ph[1])


def _conv_transpose_pad(k: int, s: int, padding: str) -> Tuple[int, int]:
    """The (lo, hi) padding of the dilated input that
    ``lax.conv_transpose`` uses (its ``_conv_transpose_padding``)."""
    if padding == "SAME":
        pad_len = k + s - 2
        lo = k - 1 if s > k - 1 else int(np.ceil(pad_len / 2))
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        lo = k - 1
    return lo, pad_len - lo


def _trace_channels(spec: CNNSpec):
    """Per layer: (input channels, input width of an fc, output shape) —
    ``_trace_shapes`` (``cnn.py:105-147``), channels-last."""
    rank = spec.spatial_rank
    out_shapes = {"__input__": tuple(spec.input_shape)}
    infos, prev = [], "__input__"
    for layer in spec.layers:
        if layer.sources:
            srcs = [out_shapes[s] for s in layer.sources]
            if layer.combine == "concat":
                in_shape = (tuple(min(s[d] for s in srcs) for d in range(rank))
                            + (sum(s[-1] for s in srcs),))
            else:
                in_shape = srcs[0]
        else:
            in_shape = out_shapes[prev]
        in_c = in_shape[-1]
        out_c = layer.out if layer.out is not None else in_c
        if layer.kind == "conv":
            out = tuple(_conv_dim(in_shape[d], layer.ksize[d],
                                  layer.strides[d], layer.padding)
                        for d in range(rank)) + (out_c,)
        elif layer.kind == "convT":
            out = tuple(in_shape[d] * layer.strides[d]
                        for d in range(rank)) + (out_c,)
        elif layer.kind in ("pool", "avgpool"):
            out = tuple(_conv_dim(in_shape[d], layer.ksize[d],
                                  layer.strides[d], "SAME")
                        for d in range(rank)) + (in_c,)
        elif layer.kind == "fc":
            out = (layer.out,)
        else:
            raise ValueError(layer.kind)
        infos.append((in_c, int(np.prod(in_shape)), out))
        out_shapes[layer.name] = out
        prev = layer.name
    return infos


def _bn_width(layer, in_c: int, in_d: int) -> int:
    """BN before the main op ('B' precedes 'M') normalizes the input, after
    it the output (``cnn.py:95-102``)."""
    before = "M" not in layer.op_order or (
        layer.op_order.index("B") < layer.op_order.index("M"))
    if before:
        return in_c if layer.kind != "fc" else in_d
    return layer.out if layer.out is not None else in_c


def _check_supported(spec: CNNSpec) -> None:
    if spec.spatial_rank != 2:
        raise NotImplementedError(
            "model: only 2-D specs are ported (3-D specs: ROADMAP Queue 1)")
    for layer in spec.layers:
        if layer.kind not in ("conv", "convT", "pool", "avgpool", "fc"):
            raise NotImplementedError(f"model: layer kind {layer.kind!r}")


def _dropout_uniform(shape, generator: torch.Generator, device,
                     layer_index: int) -> torch.Tensor:
    """The f32 uniforms of one dropout mask, drawn from ``generator`` in
    layer order, over the CHANNELS-LAST ``shape`` that JAX's ``bernoulli``
    draws (the caller permutes a conv layer's to NCHW).  ``layer_index``
    is the spec row, the tag JAX folds into its dropout key (``fold_in(key,
    i)``, ``cnn.py:230``); the port's own stream does not need it, a test
    that feeds JAX's draws does."""
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


def _center_crop(x: torch.Tensor, hw) -> torch.Tensor:
    """Crop NCHW ``x``'s spatial dims to ``hw`` around the center
    (``cnn.py:159-169``)."""
    lo_h = (x.shape[2] - hw[0]) // 2
    lo_w = (x.shape[3] - hw[1]) // 2
    return x[:, :, lo_h:lo_h + hw[0], lo_w:lo_w + hw[1]]


def _channel_view(t: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over NCHW or (b, d) ``h``."""
    return t.view(-1, 1, 1) if h.dim() == 4 else t


def _batch_norm(h, gamma, beta, stats, train: bool, decay: float,
                eps: float = 1e-3):
    """``_batch_norm`` (``cnn.py:371-394``) on NCHW or (b, d) ``h``.
    ``stats`` is the layer's running ``{"mean", "var"}`` (f32) or None.
    Batch statistics are the biased ones, reduced in f32 and rounded to
    ``h``'s dtype (``jnp.mean`` / ``jnp.var`` upcast a bf16 input); the
    normalization runs at ``h``'s dtype.  Returns ``(out, new_stats)``:
    the stats moved toward the batch's at ``decay`` when ``train`` and
    ``stats`` are given, else ``stats`` as it was."""
    dt = h.dtype
    dims = (0, 2, 3) if h.dim() == 4 else (0,)
    if train or stats is None:
        h32 = h.float()
        m32 = h32.mean(dim=dims, keepdim=True)
        mean = m32.reshape(-1)
        var = torch.square(h32 - m32).mean(dim=dims)
        mean, var = mean.to(dt), var.to(dt)
    else:
        mean, var = stats["mean"].to(dt), stats["var"].to(dt)
    eps_t = h.new_full((), eps)
    normed = ((h - _channel_view(mean, h))
              / _channel_view(torch.sqrt(var + eps_t), h))
    out = normed * _channel_view(gamma.to(dt), h) + _channel_view(
        beta.to(dt), h)
    if train and stats is not None:
        d32 = np.float32(decay)
        keep = float(d32)
        move = float(np.float32(1.0 - decay))
        stats = {"mean": keep * stats["mean"] + move * mean.float(),
                 "var": keep * stats["var"] + move * var.float()}
    return out, stats


class ConvT(nn.Module):
    """A transposed conv's parameters: ``weight`` in the conv layout
    ``(out, in, kh, kw)`` and ``bias`` (module docstring)."""

    def __init__(self, in_c: int, out_c: int, ksize, strides):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((out_c, in_c) + tuple(ksize)))
        self.bias = nn.Parameter(torch.zeros(out_c))
        self.stride = tuple(strides)


class CNN(nn.Module):
    """The spec's network; submodules are named after the spec rows
    (``conv1``, ``fc1``, ...) so ``state_dict`` keys are
    ``<layer>.weight`` / ``<layer>.bias`` (and ``<layer>.gamma`` /
    ``<layer>.beta`` for batch norm)."""

    def __init__(self, spec: CNNSpec):
        super().__init__()
        _check_supported(spec)
        self.spec = spec
        self.act = _ACTS[spec.activation]
        self._bn_widths: Dict[str, int] = {}
        # outputs a later layer reads through ``sources``
        self._kept = {s for layer in spec.layers for s in layer.sources}
        for layer, (in_c, in_d, _) in zip(spec.layers, _trace_channels(spec)):
            out_c = layer.out if layer.out is not None else in_c
            if layer.kind == "conv":
                (kh, kw), (sh, sw) = layer.ksize, layer.strides
                # odd kernels at stride 1 pad SAME symmetrically in the
                # module; other SAME convs pad in ``pad_input``
                sym = ((kh - 1) // 2, (kw - 1) // 2) if (
                    layer.padding == "SAME" and (sh, sw) == (1, 1)
                    and kh % 2 and kw % 2) else (0, 0)
                mod = nn.Conv2d(in_c, out_c, (kh, kw), (sh, sw), padding=sym)
            elif layer.kind == "convT":
                mod = ConvT(in_c, out_c, layer.ksize, layer.strides)
            elif layer.kind in ("pool", "avgpool"):
                mod = None
            else:
                mod = nn.Linear(in_d, layer.out)
            if mod is not None:
                if "B" in layer.op_order:
                    width = _bn_width(layer, in_c, in_d)
                    mod.register_parameter("gamma",
                                           nn.Parameter(torch.ones(width)))
                    mod.register_parameter("beta",
                                           nn.Parameter(torch.zeros(width)))
                    self._bn_widths[layer.name] = width
                self.add_module(layer.name, mod)

    def init_state(self, device=None) -> Dict[str, Dict[str, torch.Tensor]]:
        """Fresh BN running statistics: mean 0, var 1, f32 (``cnn.py:88``);
        empty without batch norm."""
        dev = next(self.parameters()).device if device is None else device
        return {name: {"mean": torch.zeros(w, device=dev),
                       "var": torch.ones(w, device=dev)}
                for name, w in self._bn_widths.items()}

    def pad_input(self, layer, h: torch.Tensor) -> torch.Tensor:
        """NCHW ``h`` with the SAME padding a conv (zeros, where its
        module does not pad itself) or a pool (``-inf`` for max, zeros for
        average) takes at ``h``'s own spatial size."""
        if layer.padding != "SAME" or (
                layer.kind == "conv"
                and getattr(self, layer.name).padding != (0, 0)):
            return h
        pads = _pads_for(layer, h.shape[2:])
        if not any(pads):
            return h
        return F.pad(h, pads, value=float("-inf") if layer.kind == "pool"
                     else 0.0)

    def _main(self, layer, mod, h, dt):
        """The layer's main op on NCHW (or flat) ``h`` at dtype ``dt``."""
        if layer.kind in ("conv", "pool", "avgpool"):
            h = self.pad_input(layer, h)
        if getattr(mod, "W_q", None) is not None:
            return _int8_main(layer, mod, h, dt)
        if layer.kind == "conv":
            if dt.itemsize >= 4:               # f32, or an f64 reference
                return mod(h)
            return (conv2d_f32acc(h, mod.weight.to(dt), mod.stride,
                                  mod.padding)
                    + mod.bias.to(dt)[:, None, None]).to(dt)
        if layer.kind == "convT":
            return self._conv_transpose(layer, mod, h, dt)
        if layer.kind == "pool":
            return F.max_pool2d(h, layer.ksize, layer.strides)
        if layer.kind == "avgpool":
            # a window sum over the zero-padded input over the full window
            # size, as ``reduce_window(add) / prod(ksize)`` (``:356-361``)
            s = F.avg_pool2d(h, layer.ksize, layer.strides,
                             divisor_override=1)
            return s / h.new_full((), float(np.prod(layer.ksize)))
        if h.dim() > 2:
            h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        if dt.itemsize >= 4:
            return mod(h)
        return (linear_f32acc(h, mod.weight.to(dt)) + mod.bias.to(dt)).to(dt)

    @staticmethod
    def _conv_transpose(layer, mod, h, dt):
        """``lax.conv_transpose`` (module docstring): the full transposed
        conv of the flipped kernel, cropped (or zero-extended) by ``F.pad``
        to XLA's window, plus the bias at ``h``'s dtype."""
        w = mod.weight.transpose(0, 1).flip(2, 3)
        if dt.itemsize >= 4 or h.device.type == "cuda":
            y = F.conv_transpose2d(h, w.to(dt), None, mod.stride)
        else:
            # the host's bf16 transposed conv: f32 sums rounded once
            y = F.conv_transpose2d(h.float(), w.float(), None,
                                   mod.stride).to(dt)
        pads = []
        for d in (1, 0):                   # F.pad's order: w, then h
            k, s = layer.ksize[d], layer.strides[d]
            lo, _ = _conv_transpose_pad(k, s, layer.padding)
            n_out = h.shape[2 + d] * s
            off = k - 1 - lo
            pads += [-off, off + n_out - y.shape[2 + d]]
        y = F.pad(y, pads)
        return y + mod.bias.to(dt)[:, None, None]

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                nchw: bool = False, mc_dropout: bool = False,
                state: Optional[Dict] = None,
                bn_decay: float = 0.999,
                keep_probes: bool = False) -> CNNOutput:
        """``apply_cnn`` (``cnn.py:180-252``).  ``train`` turns on dropout
        (with a ``generator``) and BN batch statistics; ``state`` holds the
        BN running statistics, which eval mode normalizes with and which
        ``train`` moves at ``bn_decay``; the returned ``state`` is the new
        one (None when none was given).  ``keep_probes`` returns the
        outputs of the layers in ``spec.probes`` (channels-last, after
        dropout) under ``probes``, keyed by layer name; JAX's jitted
        callers drop the probes they do not read, so they are kept only
        on request here."""
        h = x if nchw else x.permute(0, 3, 1, 2)
        dt = h.dtype
        feature = None
        use_dropout = (train or mc_dropout) and generator is not None
        new_state = {} if state is not None else None
        probes = {} if keep_probes else None
        outputs: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(self.spec.layers):
            if layer.sources:
                srcs = [outputs[s] for s in layer.sources]
                if layer.combine == "concat":
                    hw = (min(s.shape[2] for s in srcs),
                          min(s.shape[3] for s in srcs))
                    h = torch.cat([_center_crop(s, hw) for s in srcs], dim=1)
                else:
                    h = srcs[0]
                    for s in srcs[1:]:
                        h = h + _center_crop(s, h.shape[2:])
            mod = getattr(self, layer.name, None)
            ops = "M" if layer.kind in ("pool", "avgpool") else layer.op_order
            for op in ops:
                if op == "M":
                    h = self._main(layer, mod, h, dt)
                elif op == "B":
                    h, st = _batch_norm(
                        h, mod.gamma, mod.beta,
                        None if state is None else state.get(layer.name),
                        train, bn_decay)
                    if new_state is not None and st is not None:
                        new_state[layer.name] = st
                elif op == "A":
                    h = self.act(h)
            if layer.dropout > 0 and use_dropout:
                keep = 1.0 - layer.dropout
                if h.dim() == 4:
                    b, c, hh, ww = h.shape
                    u = _dropout_uniform((b, hh, ww, c), generator, h.device,
                                         i).permute(0, 3, 1, 2)
                else:
                    u = _dropout_uniform(h.shape, generator, h.device, i)
                # a tensor divisor at h's dtype: JAX divides by the weakly
                # typed keep rounded to h's dtype, and torch would turn a
                # Python-scalar divisor into a reciprocal multiply
                div = h.new_full((), keep)
                h = torch.where(u < keep, h / div, torch.zeros_like(h))
            if layer.name in self._kept:
                outputs[layer.name] = h
            if keep_probes and i in self.spec.probes:
                probes[layer.name] = (h.permute(0, 2, 3, 1) if h.dim() == 4
                                      else h)
            if i == self.spec.feature_layer:
                f = h.permute(0, 2, 3, 1) if h.dim() == 4 else h
                feature = f if self.spec.fcn else f.reshape(f.shape[0], -1)
        if h.dim() == 4:
            h = h.permute(0, 2, 3, 1)
        log_sigma = None
        if self.spec.aleatoric:
            h, log_sigma = h.chunk(2, dim=-1)
        logits = h if h.dtype == torch.float64 else h.float()
        return CNNOutput(logits=logits,
                         posteriors=torch.softmax(logits, dim=-1),
                         prediction=torch.argmax(logits, dim=-1),
                         feature=feature, log_sigma=log_sigma,
                         state=new_state, probes=probes)


def init_cnn(spec: CNNSpec, seed: int, device=None) -> CNN:
    """He-initialized network (``cnn.py:55-92``): weights ~ N(0, 2/fan_in),
    zero biases, BN gamma 1 and beta 0, drawn from a ``torch.Generator``
    seeded with ``seed`` on the host, then moved to ``device`` (``None``:
    the card).  The BN running statistics are :meth:`CNN.init_state`."""
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
