"""Full-volume inference (counterpart of
``nnal_tpu/evaluation/inference.py``).

* Patch-wise: :func:`full_slice_patchwise` scores every voxel of the given
  axial slices through a pool evaluator (the reference's
  ``full_slice_eval``, PW_analyze_results.py:673-770); a
  :class:`~nnal_tpu_torch.scoring.grid_eval.GridPoolEvaluator` is
  re-spaced to stride 1, so the slices ride the im2col sweep, and all of
  them go through one ``evaluate`` call (each touched z-slab is swept
  once).  :func:`full_volume_patchwise` stacks every slice.
* Dense: :class:`FCNInference` runs an fcn spec (FC-DenseNet-103) over a
  slice stack in batches (the reference's ``full_slice_segment``,
  eval_utils.py:104-237) with the ops ``prediction``, ``posteriors``,
  ``MC-posteriors``, ``sigma``, ``MC-sigma``, ``output`` and ``loss``,
  through the dense evaluator's forward (``scoring/fcn_eval.fcn_forward``:
  the BN running statistics when given, deterministic cuDNN).  MC pass
  ``t`` draws its dropout from ``key_generator(rng, t)``, as JAX keys it
  ``fold_in(rng, t)``, and the passes are averaged ``(val + t*acc) /
  (t+1)``.  :class:`ShapeCachedFCN` keeps one per input shape.

A model is a :class:`~nnal_tpu_torch.models.cnn.CNN`, float or int8
(``models/quant.quantized_cnn``); a bf16 ``compute_dtype`` casts the
input and each layer casts its weights per call, as JAX's
``cast_float_params`` does.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from nnal_tpu_torch.core import rng as core_rng
from nnal_tpu_torch.core.device import resolve_device
from nnal_tpu_torch.data.indexing import expand_raveled_inds
from nnal_tpu_torch.models.losses import fcn_cross_entropy
from nnal_tpu_torch.scoring.fcn_eval import fcn_forward
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator
from nnal_tpu_torch.scoring.uncertainty import running_average

FCN_OPS = ("prediction", "posteriors", "MC-posteriors", "sigma", "MC-sigma",
           "output", "loss")


def full_slice_patchwise(evaluator, model, slices: Sequence[int],
                         op: str = "prediction") -> Dict[int, np.ndarray]:
    """``{z: (H, W) array}`` of ``op`` at every voxel of the axial slices
    ``slices`` (``inference.py:30-56``)."""
    if isinstance(evaluator, GridPoolEvaluator) \
            and evaluator.grid_spacing != 1:
        evaluator = evaluator.with_spacing(1)
    s = evaluator.orig_shape
    slices = list(slices)
    if not slices:
        return {}
    inds2d = np.arange(s[0] * s[1])
    all_inds = np.concatenate(
        [expand_raveled_inds(inds2d, z, 2, s) for z in slices])
    vals = evaluator.evaluate(model, all_inds, (op,))[op]
    per = s[0] * s[1]
    return {z: np.asarray(vals[i * per:(i + 1) * per]).reshape(s[0], s[1])
            for i, z in enumerate(slices)}


def full_volume_patchwise(evaluator, model,
                          op: str = "prediction") -> np.ndarray:
    """The (H, W, D) volume of ``op`` (``inference.py:59-63``)."""
    s = evaluator.orig_shape
    planes = full_slice_patchwise(evaluator, model, range(s[2]), op)
    return np.stack([planes[z] for z in range(s[2])], axis=2)


class FCNInference:
    """Slice-batched dense inference (``inference.py:66-153``)."""

    def __init__(self, spec, batch: int = 4, compute_dtype=None,
                 bn_state=None, device=None):
        if not getattr(spec, "fcn", False):
            raise ValueError("FCNInference requires a dense-prediction spec")
        self.spec = spec
        self.batch = int(batch)
        self.compute_dtype = compute_dtype
        self.bn_state = bn_state
        self.device = resolve_device(device)

    @torch.no_grad()
    def segment(self, model, vol_slices: np.ndarray, op: str = "prediction",
                mc_T: int = 10, rng=0, labels=None) -> np.ndarray:
        """``vol_slices``: (n, H, W, C).  ``op`` as in the module docstring:
        ``sigma`` / ``MC-sigma`` are ``exp`` of the aleatoric head (the
        mean over ``mc_T`` passes for the MC one), ``output`` the f32
        logits, ``loss`` each slice's mean CE against ``labels`` ((n, H, W,
        c) one-hots, NaN for unlabeled voxels) at f32 without dropout."""
        if op not in FCN_OPS:
            raise ValueError(f"unknown op {op!r}")
        if op == "loss" and labels is None:
            raise ValueError("op='loss' needs one-hot labels")
        outs = []
        for lo in range(0, vol_slices.shape[0], self.batch):
            xs = torch.as_tensor(
                np.asarray(vol_slices[lo:lo + self.batch], np.float32),
                device=self.device)
            if op in ("MC-posteriors", "MC-sigma"):
                acc = 0.0
                for t in range(int(mc_T)):
                    out = fcn_forward(
                        model, xs, self.compute_dtype, self.bn_state, True,
                        core_rng.key_generator(rng, t, self.device))
                    val = (out.posteriors if op == "MC-posteriors"
                           else torch.exp(out.log_sigma.float()))
                    acc = running_average(val, acc, t)
                outs.append(acc.cpu().numpy())
            elif op == "loss":
                ys = torch.as_tensor(
                    np.asarray(labels[lo:lo + self.batch], np.float32),
                    device=self.device)
                lg = fcn_forward(model, xs, None, self.bn_state).logits
                outs.append(torch.stack([
                    fcn_cross_entropy(lg[i:i + 1], ys[i:i + 1])
                    for i in range(lg.shape[0])]).cpu().numpy())
            else:
                out = fcn_forward(model, xs, self.compute_dtype,
                                  self.bn_state)
                if op == "sigma":
                    outs.append(np.exp(out.log_sigma.float().cpu().numpy()))
                else:
                    # int32 labels, as JAX's argmax
                    outs.append({"prediction": out.prediction.int(),
                                 "posteriors": out.posteriors,
                                 "output": out.logits}[op].cpu().numpy())
        return np.concatenate(outs, axis=0)


class ShapeCachedFCN:
    """One :class:`FCNInference` per input spatial shape
    (``inference.py:156-172``; the reference's
    ``models_dict_for_different_sizes``): ``spec_factory(shape)`` builds
    the spec of a shape the first time it is asked for."""

    def __init__(self, spec_factory, bn_state=None, device=None):
        self.spec_factory = spec_factory
        self.bn_state = bn_state
        self.device = resolve_device(device)
        self._cache: Dict = {}

    def for_shape(self, shape) -> FCNInference:
        shape = tuple(shape)
        if shape not in self._cache:
            self._cache[shape] = FCNInference(self.spec_factory(shape),
                                              bn_state=self.bn_state,
                                              device=self.device)
        return self._cache[shape]
