"""Weights across frameworks: the JAX package's params pytree
``{layer: {"W", "b", "gamma", "beta"}}`` (conv and transposed-conv W in
HWIO, or DHWIO for a 3-D spec, fc W as (in, out)) as numpy, and the
port's ``state_dict`` (``<layer>.weight`` in OIHW / OIDHW or (out, in),
``<layer>.bias``,
``<layer>.gamma``, ``<layer>.beta``); and the BN running state
``{layer: {"mean", "var"}}``, the same dict in both packages.

Every direction is a pure layout move (transposes), so a round trip is
exact.  A transposed conv's kernel moves like a conv's: the port holds it
in the conv layout and flips it in the forward (``models/cnn.py``).  The
fc flatten order needs no permutation here: the port flattens
channels-last like the JAX package.  An int8-quantized layer
(``models/quant``) carries ``W_q`` (int8, moved like ``W``) and
``w_scale`` (f32, one scale per output: the JAX layout's last axis is the
port's first, so the vector itself is the same) in place of ``W``; int8
leaves stay int8 both ways.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _w_to_port(w: np.ndarray) -> np.ndarray:
    if w.ndim in (4, 5):                 # HWIO -> OIHW, DHWIO -> OIDHW
        return w.transpose(w.ndim - 1, w.ndim - 2, *range(w.ndim - 2))
    if w.ndim == 2:                      # (in, out) -> (out, in)
        return w.T
    raise ValueError(f"unsupported weight rank {w.ndim}")


def _w_to_jax(t: torch.Tensor) -> torch.Tensor:
    if t.dim() in (4, 5):                # OIHW -> HWIO, OIDHW -> DHWIO
        return t.permute(*range(2, t.dim()), 1, 0)
    if t.dim() == 2:
        return t.t()
    raise ValueError(f"unsupported weight rank {t.dim()}")


def from_jax_params(np_params: Mapping[str, Mapping[str, np.ndarray]]
                    ) -> Dict[str, torch.Tensor]:
    """JAX-layout params -> a ``state_dict`` for :class:`models.cnn.CNN`."""
    out = {}
    for layer, p in np_params.items():
        unknown = set(p) - {"W", "W_q", "w_scale", "b", "gamma", "beta"}
        if unknown:
            raise NotImplementedError(
                f"params of {layer!r} carry {sorted(unknown)}; only "
                "W/W_q/w_scale/b/gamma/beta layers are ported")
        if "W_q" in p:
            w = np.asarray(p["W_q"], np.int8)
            out[f"{layer}.W_q"] = torch.from_numpy(
                np.ascontiguousarray(_w_to_port(w)))
        else:
            w = np.asarray(p["W"], np.float32)
            out[f"{layer}.weight"] = torch.from_numpy(
                np.ascontiguousarray(_w_to_port(w)))
        for k, port_k in (("b", "bias"), ("gamma", "gamma"),
                          ("beta", "beta"), ("w_scale", "w_scale")):
            if k in p:
                out[f"{layer}.{port_k}"] = torch.from_numpy(
                    np.array(p[k], np.float32))
    return out


def bn_state_to_port(np_state, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """A BN running state (numpy, or None) as f32 tensors on ``device``."""
    return {layer: {k: torch.from_numpy(np.array(v, np.float32)).to(device)
                    for k, v in d.items()}
            for layer, d in (np_state or {}).items()}


def bn_state_to_jax(state) -> Dict[str, Dict[str, np.ndarray]]:
    """A BN running state as host f32 numpy arrays."""
    return {layer: {k: v.detach().to("cpu", torch.float32).numpy()
                    for k, v in d.items()}
            for layer, d in (state or {}).items()}


def to_jax_tensors(state: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Like :func:`to_jax_params`, but each leaf stays a tensor where it
    lives: a contiguous JAX-layout copy, detached — a snapshot that later
    in-place updates of ``state`` do not reach."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, t in state.items():
        layer, _, kind = key.rpartition(".")
        t = t.detach()
        if kind in ("weight", "W_q"):
            out.setdefault(layer, {})[
                "W" if kind == "weight" else kind] = _w_to_jax(t).contiguous()
        elif kind in ("bias", "gamma", "beta", "w_scale"):
            out.setdefault(layer, {})[
                "b" if kind == "bias" else kind] = t.clone()
        else:
            raise ValueError(f"unexpected state key {key!r}")
    return out


def to_jax_params(state: Mapping[str, torch.Tensor]
                  ) -> Dict[str, Dict[str, np.ndarray]]:
    """A port ``state_dict`` (or any mapping shaped like one, e.g. Adam
    moments keyed the same way) -> JAX-layout float32 numpy params (int8
    ``W_q`` stays int8)."""
    return {layer: {k: v.to("cpu", v.dtype if k == "W_q"
                            else torch.float32).numpy()
                    for k, v in d.items()}
            for layer, d in to_jax_tensors(state).items()}
