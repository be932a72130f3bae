"""Per-subject whole-volume prediction driver (counterpart of
``nnal_tpu/cli/run_on_subjects.py``).

For each held subject: score every voxel with a method's current weights
(``full_volume_patchwise`` through a stride-1 ``GridPoolEvaluator``),
compute the F-measure against its mask and, with ``save_dir``, write
``<save_dir>/<i>/segs.npy`` (uint8) and ``F1_score.txt``.  ``params`` may
be a float or an int8-quantized JAX-layout tree (``models/quant``);
``compute_dtype`` (``torch.bfloat16``) is the evaluator's.  Runs on
``device`` (None: the card; CUDA missing raises).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from nnal_tpu_torch.core.device import resolve_device
from nnal_tpu_torch.core.journal import MethodJournal
from nnal_tpu_torch.data.patches import pad_volumes
from nnal_tpu_torch.data.stats import multimg_stats
from nnal_tpu_torch.evaluation.inference import full_volume_patchwise
from nnal_tpu_torch.evaluation.metrics import f_measure
from nnal_tpu_torch.models.bridge import from_jax_params
from nnal_tpu_torch.models.checkpoint import load_checkpoint
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.quant import is_quantized, quantized_cnn
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator


def serving_model(spec, params, device) -> CNN:
    """The :class:`CNN` serving a JAX-layout tree, int8 when it is
    quantized."""
    if is_quantized(params):
        return quantized_cnn(spec, params, device=device)
    model = CNN(spec)
    model.load_state_dict(from_jax_params(params))
    return model.to(device)


def run_on_subjects(expr, method_name: str, subjects: Sequence,
                    save_dir: Optional[str] = None, params=None,
                    device=None, compute_dtype=None) -> dict:
    """``subjects``: ``(modality_vols, mask)`` pairs.  Returns ``{subject
    index: F-measure}`` (``run_on_subjects.py:19-58``); ``params`` None
    reads the method's ``curr_weights.npz``."""
    dev = resolve_device(device)
    spec = expr.build_model()
    if params is None:
        j = MethodJournal(expr.root_dir, method_name)
        params = load_checkpoint(j.path("curr_weights.npz"))[0]
    model = serving_model(spec, params, dev)
    patch_shape = tuple(expr.config.model.patch_shape)
    stats = multimg_stats(subjects)
    out = {}
    for i, (vols, mask) in enumerate(subjects):
        mu, sd = stats[i, 0::2], stats[i, 1::2]
        ev = GridPoolEvaluator(spec, pad_volumes(vols, patch_shape,
                                                 device=dev),
                               mu, sd, patch_shape,
                               tuple(np.asarray(vols[0]).shape),
                               grid_spacing=expr.config.data.grid_spacing,
                               ntb=expr.config.query.ntb,
                               compute_dtype=compute_dtype)
        preds = full_volume_patchwise(ev, model, "prediction")
        f1 = f_measure(preds, np.asarray(mask))
        out[i] = f1
        if save_dir:
            sub = os.path.join(save_dir, str(i))
            os.makedirs(sub, exist_ok=True)
            np.save(os.path.join(sub, "segs.npy"), preds.astype(np.uint8))
            np.savetxt(os.path.join(sub, "F1_score.txt"), [f1])
    return out
