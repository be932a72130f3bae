"""Weight surgery (counterpart of ``nnal_tpu/models/surgery.py``).

``extend_params_to_aleatoric`` works on the JAX-layout params tree (numpy
in, numpy out), so a checkpoint of either package can be extended; load
the result into a ``CNN`` built from ``specs.with_aleatoric_head``.  The
VGG19 h5 import waits for the classification engine (ROADMAP Queue 1
item 10).
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
