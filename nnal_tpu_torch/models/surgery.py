"""Weight surgery (counterpart of ``nnal_tpu/models/surgery.py``).

``extend_params_to_aleatoric`` works on the JAX-layout params tree (numpy
in, numpy out), so a checkpoint of either package can be extended; load
the result into a ``CNN`` built from ``specs.with_aleatoric_head``.
``import_keras_vgg_weights`` (the VGG19 Keras-h5 import,
NNAL_tools.py:986-1048) returns the same JAX-layout tree; load it with
``CNN.load_state_dict(bridge.from_jax_params(...))``.  ``h5py`` is
imported only when a file is read.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def extend_params_to_aleatoric(params: Dict, last_layer: str) -> Dict:
    """Double ``last_layer``'s output columns, the new log-sigma half zero
    (reference ``extend_weights_to_aleatoric_mode``; ``surgery.py:15-28``).
    The other layers' arrays are shared with ``params``, not copied."""
    out = {k: dict(v) for k, v in params.items()}
    W = np.asarray(out[last_layer]["W"])
    b = np.asarray(out[last_layer]["b"])
    extW = np.zeros(W.shape[:-1] + (2 * W.shape[-1],), W.dtype)
    extW[..., :W.shape[-1]] = W
    extb = np.zeros(2 * b.shape[0], b.dtype)
    extb[:b.shape[0]] = b
    out[last_layer]["W"] = extW
    out[last_layer]["b"] = extb
    return out


def import_keras_vgg_weights(h5_path: str, params_template: Dict,
                             layer_map: Dict[str, str]) -> Dict:
    """Import Keras-layout VGG weights (reference ``read_pretrained_VGG19``
    / ``load_weights_VGG19``, NNAL_tools.py:986-1048): conv kernels are
    already HWIO; dense kernels are (in, out), as in the JAX-layout tree, so
    only naming differs.  ``layer_map``: our layer name -> h5 group name."""
    import h5py

    out = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
           for k, v in params_template.items()}
    with h5py.File(h5_path, "r") as f:
        for ours, theirs in layer_map.items():
            grp = f[theirs]
            keys = sorted(grp.keys())
            w_key = next(k for k in keys if "W" in k or "kernel" in k)
            b_key = next(k for k in keys if "b" in k.lower()
                         and k != w_key)
            W = np.asarray(grp[w_key])
            if W.shape != out[ours]["W"].shape and \
                    W.T.shape == out[ours]["W"].shape:
                W = W.T
            out[ours]["W"] = W
            out[ours]["b"] = np.asarray(grp[b_key]).reshape(
                out[ours]["b"].shape)
    return out
