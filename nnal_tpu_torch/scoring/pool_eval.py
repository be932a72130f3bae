"""Batched pool evaluation over arbitrary voxel indices (counterpart of
``nnal_tpu/scoring/pool_eval.py``).

Each chunk of ``ntb`` indices is gathered and normalized on the device
(kernel K2 on a CUDA volume, see ``ops/gather.py``) and run through the
model; only the requested outputs are kept.  The ragged last chunk is just
shorter: PyTorch runs eagerly, so the JAX package's pad-and-mask (which
keeps one compiled shape) would only add work.  With a bf16
``compute_dtype`` the patches are gathered in f32, then cast, and the
forward casts the weights per call (``pool_eval.py:28-59``): no bf16 copy
of the weights outlives a call, so none can be older than the last
finetune.

MC-dropout passes (``mc_rng``, an integer key) run the same forward with
``mc_dropout`` on.  Each chunk draws from its own generator, keyed on the
key and the chunk's start ``lo`` as the JAX package folds it
(``pool_eval.py:143``), so a chunk's masks do not depend on what ran
before it; MC chunks keep the full ``ntb`` rows, the ragged last one
padded with index 0 and trimmed as in JAX, so a row's mask depends only
on (key, chunk, row).  An int8-quantized model (``models/quant``) pads
the same way: its per-tensor activation scales are taken over the whole
chunk, padding rows included, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from nnal_tpu_torch.core import rng as core_rng
from nnal_tpu_torch.core.device import set_precision
from nnal_tpu_torch.data.patches import (gather_patches_normalized,
                                         pad_volumes)
from nnal_tpu_torch.models.quant import is_quantized
from nnal_tpu_torch.scoring.uncertainty import running_average


def eval_compute_dtype(name):
    """The config's ``model.dtype`` / ``train_dtype`` string -> a compute
    dtype (``pool_eval.py:78-86``): f32 -> None; bf16 -> ``torch.bfloat16``;
    anything else raises, as in the JAX package."""
    if name in (None, "float32", "f32"):
        return None
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"unsupported eval dtype {name!r}")


def cast_input(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return x if compute_dtype is None else x.to(compute_dtype)


def select_output(out, op: str, nclass: int) -> torch.Tensor:
    """One requested output of a forward pass (the ``ops`` vocabulary of
    the JAX evaluators)."""
    if op == "posteriors":
        # binary models expose P(class 1) as a 1-D score row
        return out.posteriors[:, 1] if nclass == 2 else out.posteriors
    if op == "prediction":
        return out.prediction
    if op == "feature_layer":
        return out.feature
    if op == "logits":
        return out.logits
    raise ValueError(op)


def to_host(res: Dict[str, torch.Tensor], as_device: bool):
    if as_device:
        return res
    return {op: t.cpu().numpy() for op, t in res.items()}


class PoolEvaluator:
    """Evaluate model outputs over voxel-index sets of one subject; holds
    the padded device-resident volumes and normalization constants."""

    def __init__(self, spec, padded: torch.Tensor, mu, sd, patch_shape,
                 orig_shape, ntb: int = 4096, compute_dtype=None):
        # takes its device from ``padded``, so applies the policy itself
        set_precision()
        self.spec = spec
        self.padded = padded
        self.device = padded.device
        self.mu = torch.as_tensor(np.asarray(mu, np.float32)).to(self.device)
        self.sd = torch.as_tensor(np.asarray(sd, np.float32)).to(self.device)
        self.patch_shape = tuple(int(v) for v in patch_shape)
        self.orig_shape = tuple(int(v) for v in orig_shape)
        self.ntb = int(ntb)
        # None = f32; torch.bfloat16 for the bf16 sweeps (model.dtype)
        self.compute_dtype = compute_dtype

    @torch.no_grad()
    def evaluate(self, model, pool_inds, ops: Sequence[str] = ("posteriors",),
                 as_device: bool = False, *, mc_rng=None) -> Dict:
        """Sweep ``pool_inds`` in ``ntb`` chunks; returns one array per op
        (numpy, or device tensors with ``as_device``).  ``mc_rng`` (a key)
        turns MC dropout on (see the module docstring)."""
        inds_np = np.asarray(pool_inds, np.int64)
        n = len(inds_np)
        mc = mc_rng is not None
        if (mc or is_quantized(model)) and n % self.ntb:
            inds_np = np.concatenate(
                [inds_np, np.zeros(-n % self.ntb, np.int64)])
        inds = torch.as_tensor(inds_np).to(self.device)
        chunks: Dict[str, list] = {op: [] for op in ops}
        for lo in range(0, len(inds), self.ntb):
            x = gather_patches_normalized(self.padded, inds[lo:lo + self.ntb],
                                          self.mu, self.sd, self.patch_shape,
                                          self.orig_shape)
            gen = (core_rng.key_generator(mc_rng, lo, self.device)
                   if mc else None)
            out = model(cast_input(x, self.compute_dtype), mc_dropout=mc,
                        generator=gen)
            for op in ops:
                chunks[op].append(select_output(out, op, self.spec.nclass))
        return to_host({op: torch.cat(c)[:n] for op, c in chunks.items()},
                       as_device)

    @classmethod
    def from_volumes(cls, spec, vols, stats, patch_shape, ntb: int = 4096,
                     device=None) -> "PoolEvaluator":
        """An evaluator of one subject's raw volumes (``pool_eval.py:
        180-187``): pads them on ``device`` (``None``: the card) and takes
        ``mu`` and ``sd`` from the ``(m, 2)`` ``stats``."""
        orig_shape = tuple(np.asarray(vols[0]).shape)
        padded = pad_volumes(vols, patch_shape, device)
        stats = np.asarray(stats, dtype=np.float64)
        return cls(spec, padded, stats[:, 0], stats[:, 1], patch_shape,
                   orig_shape, ntb)


def mc_average_posteriors(evaluator: PoolEvaluator, model, pool_inds,
                          mc_iters: int, base_rng, as_device: bool = False):
    """Running-averaged MC-dropout posteriors over the pool: pass ``i``
    is keyed ``fold_key(base_rng, i)``, and the passes are averaged in the
    reference's order, ``(p + i*avg) / (i+1)`` (PW_NNAL.py:67-87)."""
    avg = 0.0
    for i in range(int(mc_iters)):
        p = evaluator.evaluate(model, pool_inds, ("posteriors",), True,
                               mc_rng=core_rng.fold_key(base_rng, i)
                               )["posteriors"]
        avg = running_average(p, avg, i)
    return avg if as_device else avg.cpu().numpy()


def mc_stack_posteriors(evaluator: PoolEvaluator, model, pool_inds,
                        mc_iters: int, base_rng, as_device: bool = False):
    """``(T, n)`` stack of MC-dropout pool posteriors (for BALD), pass
    ``i`` keyed as in :func:`mc_average_posteriors`."""
    rows = torch.stack([
        evaluator.evaluate(model, pool_inds, ("posteriors",), True,
                           mc_rng=core_rng.fold_key(base_rng, i)
                           )["posteriors"]
        for i in range(int(mc_iters))])
    return rows if as_device else rows.cpu().numpy()
