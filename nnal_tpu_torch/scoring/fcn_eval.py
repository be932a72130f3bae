"""Dense-model (fcn) pool evaluation over grid voxel sets (counterpart of
``nnal_tpu/scoring/fcn_eval.py``).

A dense spec (the FC-DenseNet-103 "Tiramisu") predicts every pixel of a
slice in one forward pass, so pool scoring is a whole-volume axial sweep
and a gather: no patch is extracted.  :class:`FCNGridPoolEvaluator` keeps
the ``evaluate`` contract of :class:`~nnal_tpu_torch.scoring.pool_eval.
PoolEvaluator`, so the engines, the MC helpers and the strategies drive
it unchanged: ``posteriors`` (binary: the ``(n,)`` P(y=1) row; multiclass:
the ``(n, c)`` matrix), ``prediction`` and ``feature_layer`` (the spec's
per-pixel probe, for the Tiramisu the last up-path conv).  Per-patch
full-gradient methods (influence, AU_4U) raise, as in JAX.
``hv_patch_shape`` is the window ps-random's variance filter reads: the
JAX package hands it the dense evaluator's ``(1, 1, 1)`` patch shape,
whose 0 x 0 window its convolution rejects, so the port's engines pass
the configured ``patch_shape`` (ROADMAP Queue 3).

The normalized ``(Z, H, W, C)`` slice stack lives on the device once
(normalized on the host as the JAX package does, in float64, then rounded
to f32).  A sweep runs batches of ``batch`` slices through the model with
the evaluator's ``bn_state`` (the engine's running statistics; None
normalizes by each batch's own statistics); an MC pass keys batch ``lo``'s
generator on ``(mc_rng, lo)``, as ``fold_in(rng, lo)`` (``fcn_eval.py:
83-93``).  A request for posteriors and features runs one sweep for both
(the JAX package runs two programs with the same keys, so the values are
the same).  The sweep runs on deterministic cuDNN algorithms: a
transposed conv's forward is cuDNN's backward-data convolution, whose
default algorithm adds with atomics, so a resumed campaign would
otherwise score near-ties in another order than the uninterrupted one.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from nnal_tpu_torch.core import rng as core_rng
from nnal_tpu_torch.core.device import deterministic_cudnn, resolve_device
from nnal_tpu_torch.scoring.pool_eval import cast_input, to_host

_OPS = ("posteriors", "prediction", "feature_layer")


def normalized_slices(vols, mu, sd) -> np.ndarray:
    """The ``(Z, H, W, C)`` float32 slice stack ``(v - mu) / sd`` per
    modality, computed as the JAX package does (``fcn_eval.py:51-55``)."""
    stack = np.stack([(np.asarray(v, np.float32) - m) / s
                      for v, m, s in zip(vols, np.ravel(mu), np.ravel(sd))],
                     axis=-1)
    return np.transpose(stack, (2, 0, 1, 3)).astype(np.float32)


def fcn_forward(model, x, compute_dtype=None, bn_state=None, mc=False,
                generator=None):
    """One dense forward of the ``(b, H, W, C)`` slices ``x`` at
    ``compute_dtype`` on the BN running state ``bn_state``, on
    deterministic cuDNN (module docstring); ``mc`` turns dropout on, drawn
    from ``generator``.  The evaluator's sweep and
    ``evaluation/inference.FCNInference`` both run it."""
    with deterministic_cudnn():
        return model(cast_input(x, compute_dtype), mc_dropout=mc,
                     generator=generator, state=bn_state)


class FCNGridPoolEvaluator:
    """Whole-slice dense scoring of voxel index sets for ``spec.fcn``
    models."""

    def __init__(self, spec, vols, mu, sd, orig_shape, *, batch: int = 4,
                 compute_dtype=None, bn_state=None, device=None,
                 hv_patch_shape=(1, 1, 1)):
        if not getattr(spec, "fcn", False):
            raise ValueError("FCNGridPoolEvaluator needs a dense (fcn) spec")
        self.spec = spec
        self.orig_shape = tuple(int(v) for v in orig_shape)
        self.patch_shape = (1, 1, 1)     # dense models read raw slices
        self.hv_patch_shape = tuple(hv_patch_shape)
        self.batch = int(batch)
        self.compute_dtype = compute_dtype
        self.bn_state = bn_state
        self.device = resolve_device(device)
        self.slices = torch.from_numpy(normalized_slices(vols, mu, sd)).to(
            self.device)

    @torch.no_grad()
    def _sweep(self, model, mc_rng, want_feat: bool):
        """(Z, H, W, c) posteriors, (Z, H, W) predictions and, with
        ``want_feat``, the (Z, H, W, C_f) features, on the device."""
        mc = mc_rng is not None
        posts, preds, feats = [], [], []
        for lo in range(0, self.slices.shape[0], self.batch):
            gen = (core_rng.key_generator(mc_rng, lo, self.device)
                   if mc else None)
            out = fcn_forward(model, self.slices[lo:lo + self.batch],
                              self.compute_dtype, self.bn_state, mc, gen)
            posts.append(out.posteriors)
            preds.append(out.prediction)
            if want_feat:
                if out.feature is None:
                    raise ValueError("spec has no feature_layer probe")
                feats.append(out.feature.float())
        return (torch.cat(posts), torch.cat(preds),
                torch.cat(feats) if want_feat else None)

    def evaluate(self, model, pool_inds, ops: Sequence[str] = ("posteriors",),
                 as_device: bool = False, *, mc_rng=None) -> Dict:
        """One array per op at ``pool_inds`` (numpy, or device tensors
        with ``as_device``); ``mc_rng`` (a key) turns MC dropout on."""
        unsupported = [op for op in ops if op not in _OPS]
        if unsupported:
            raise NotImplementedError(
                f"dense-model evaluator has no {unsupported} op — per-patch "
                "full-gradient query methods (influence) need the "
                "patch-wise evaluator")
        x, y, z = np.unravel_index(np.asarray(pool_inds, np.int64),
                                   self.orig_shape)
        zi, xi, yi = (torch.as_tensor(a).to(self.device) for a in (z, x, y))
        posts, preds, feats = self._sweep(model, mc_rng,
                                          "feature_layer" in ops)
        out = {}
        for op in ops:
            if op == "posteriors":
                out[op] = (posts[zi, xi, yi, 1] if self.spec.nclass == 2
                           else posts[zi, xi, yi, :])
            elif op == "prediction":
                out[op] = preds[zi, xi, yi]
            else:
                out[op] = feats[zi, xi, yi, :]
        return to_host(out, as_device)

    def segment_volume(self, model, op: str = "prediction") -> np.ndarray:
        """(H, W, Z) dense output over the whole subject: P(y=1) for
        ``posteriors``, else the prediction (``fcn_eval.py:150-155``)."""
        posts, preds, _ = self._sweep(model, None, False)
        vol = posts[..., 1] if op == "posteriors" else preds
        return np.transpose(vol.cpu().numpy(), (1, 2, 0))
