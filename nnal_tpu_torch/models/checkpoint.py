"""Checkpoints in the JAX package's npz layout (counterpart of
``nnal_tpu/models/checkpoint.py``).

One atomic ``.npz`` per save: ``params/<layer>/<W|b>`` in the JAX layout
(written through ``models/bridge``), ``bn/...``, ``__al_state__`` (JSON
bytes) and ``opt/<i>`` optimizer leaves.  The optimizer leaves follow
optax's order for the same optimizer — Adam is ``count`` then the first
moments then the second moments, each in sorted (layer, W/b) order and
JAX layout; plain SGD has none — so either package can read the other's
files.  float32 only: bf16/int8 anchors are not ported.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional

import numpy as np


def _check_dtype(dtype) -> None:
    if dtype not in (None, "float32"):
        raise NotImplementedError(
            f"ckpt_dtype={dtype!r}: only float32 checkpoints are ported")


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_checkpoint(path: str, params: Dict, *,
                    bn_state: Optional[Dict] = None,
                    al_state: Optional[dict] = None,
                    opt_state: Optional[List[np.ndarray]] = None,
                    dtype: Optional[str] = None) -> None:
    """Atomic single-file checkpoint (tmpfile + rename).  ``params`` is the
    JAX-layout numpy tree (``bridge.to_jax_params``); ``opt_state`` the
    optax-ordered leaf list (``models.optim.opt_state_leaves``)."""
    _check_dtype(dtype)
    payload = _flatten(params, "params/")
    if bn_state:
        payload.update(_flatten(bn_state, "bn/"))
    for i, leaf in enumerate(opt_state or ()):
        payload[f"opt/{i:04d}"] = np.asarray(leaf)
    if al_state is not None:
        payload["__al_state__"] = np.frombuffer(
            json.dumps(al_state).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
    os.close(fd)
    try:
        np.savez(tmp, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str):
    """Returns ``(params, bn_state, teacher_params, al_state)`` with numpy
    leaves in the JAX layout — the JAX loader's contract."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    marked = [k for k in flat if "@" in k]
    if marked:
        raise NotImplementedError(
            f"{path}: bf16/int8-encoded entries ({marked[0]}, ...) — only "
            "float32 checkpoints are ported")
    al_state = None
    if "__al_state__" in flat:
        al_state = json.loads(flat.pop("__al_state__").tobytes().decode())
    groups = {"params": {}, "bn": {}, "teacher": {}}
    for k, v in flat.items():
        head, _, rest = k.partition("/")
        groups.setdefault(head, {})[rest] = v
    params = _unflatten(groups["params"])
    bn = _unflatten(groups["bn"]) if groups["bn"] else None
    teacher = _unflatten(groups["teacher"]) if groups["teacher"] else None
    return params, bn, teacher, al_state


def load_opt_leaves(path: str) -> List[np.ndarray]:
    """The checkpoint's ``opt/<i>`` leaves in order (empty if none)."""
    with np.load(path, allow_pickle=False) as z:
        keys = sorted(k for k in z.files if k.startswith("opt/"))
        return [z[k] for k in keys]
