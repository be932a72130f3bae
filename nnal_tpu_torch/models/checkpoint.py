"""Checkpoints in the JAX package's npz layout (counterpart of
``nnal_tpu/models/checkpoint.py``).

One atomic ``.npz`` per save: ``params/<layer>/<W|b>`` in the JAX layout
(written through ``models/bridge``), ``bn/...``, the mean teacher's
``teacher/<layer>/<W|b>``, ``__al_state__`` (JSON bytes) and ``opt/<i>``
optimizer leaves.  The optimizer leaves follow
optax's order for the same optimizer — Adam is ``count`` then the first
moments then the second moments, each in sorted (layer, W/b) order and
JAX layout; plain SGD has none — so either package can read the other's
files.

Anchor storage dtypes (``ckpt_dtype``, ``checkpoint.py:31-190``):
``bfloat16`` stores every float32 leaf as bf16 bits (uint16 under an
``@bf16`` key); ``int8`` stores each weight matrix of the params and
teacher groups as int8 with one f32 scale per slice of the JAX layout's
last axis (the output channel or feature; ``@i8`` / ``@i8s`` keys) and
everything else as bf16.  Leaves
may be numpy arrays or torch tensors on any device: a tensor is encoded
where it lives (on the card: before the pull, so fewer bytes cross) and a
numpy array on the host, with the same IEEE f32 operations, so both
encodes and the JAX package's numpy encode agree bit for bit.  ``round_trip_bf16`` and
``round_trip_int8`` are the decode of that encode, which the engine adopts
into its live state at each anchor (``engine/common.py``).

``load_reference_h5`` / ``save_reference_h5`` read and write the
reference's HDF5 layout (one group per layer with ``Weight`` / ``Bias``
datasets) as JAX-layout trees, as the JAX package's do; bridge them with
``models/bridge``.  ``h5py`` is imported only inside these two.  The JAX
package's orbax save and load (``checkpoint.py:345-375``) write an orbax
PyTree directory, a JAX-only format, and are not ported: the npz format
here is the one both packages read.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

_BF16 = "@bf16"
_I8 = "@i8"
_I8S = "@i8s"


def _as_tensor(x) -> torch.Tensor:
    """A tensor where it lives, or a host tensor over a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.ascontiguousarray(x))


def _bf16_bits(x) -> np.ndarray:
    """float32 -> bf16 (round to nearest even) as uint16 bits on the host;
    a tensor is cast where it lives before the pull."""
    return _as_tensor(x).to(torch.bfloat16).view(torch.int16).cpu(
    ).numpy().view(np.uint16)


def _bf16_decode(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bits -> float32 (exact: bf16 is f32's top half)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def round_trip_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 -> f32 rounding (``checkpoint.py:44-57``)."""
    return x.to(torch.bfloat16).to(x.dtype)


def i8_parts(x: torch.Tensor, axis: int = -1):
    """Symmetric int8 quantization with one scale per index of ``axis``
    (``_i8_parts``, ``checkpoint.py:70-76``): ``s = max|x| / 127`` over the
    other axes, in f32; ``q = clip(round(x / s), +-127)`` with
    round-half-to-even, where a zero scale divides by 1.  ``axis`` is -1
    for the JAX layout and 0 for the port's (the output channel or
    feature either way).  Every step is one IEEE f32 operation, so the
    card, the host and the JAX package's numpy encode agree bit for
    bit."""
    red = tuple(d for d in range(x.dim()) if d != axis % x.dim())
    amax = x.abs().amax(dim=red, keepdim=True)
    # tensor / tensor: a python-scalar divisor may become a multiply by
    # its reciprocal on the card, which rounds differently
    s = amax / torch.full_like(amax, 127.0)
    safe = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)
    return q, s


def round_trip_int8(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Quantize-dequantize of a weight matrix (``round_trip_int8``,
    ``checkpoint.py:86-98``): the IEEE f32 ``q * s`` the loader decodes."""
    q, s = i8_parts(x, axis)
    return q.to(x.dtype) * s


def _is_f32(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.dtype == torch.float32
    return np.asarray(v).dtype == np.float32


def _to_host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _encode_bf16(payload: Dict) -> Dict[str, np.ndarray]:
    """Every float32 leaf -> bf16 bits under an ``@bf16`` key
    (``_encode_payload_bf16`` + ``_mark_and_view``, ``:138-168``); other
    leaves (ints, the al_state bytes) unchanged."""
    return {(k + _BF16 if _is_f32(v) else k):
            (_bf16_bits(v) if _is_f32(v) else _to_host(v))
            for k, v in payload.items()}


def _encode_int8(payload: Dict) -> Dict[str, np.ndarray]:
    """Weight matrices of the params and teacher groups -> ``@i8`` q +
    ``@i8s`` scale (per last axis of the JAX layout); the rest -> bf16
    (``:106-135``).
    Optimizer moments stay bf16: int8 second moments would span too few
    decades."""
    out, rest = {}, {}
    for k, v in payload.items():
        if (k.startswith(("params/", "teacher/")) and v.ndim >= 2
                and _is_f32(v)):
            q, s = i8_parts(_as_tensor(v), -1)
            out[k + _I8], out[k + _I8S] = _to_host(q), _to_host(s)
        else:
            rest[k] = v
    out.update(_encode_bf16(rest))
    return out


def _decode_flat(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Load-side inverse of the encodes (``:170-190``): marked entries
    come back as float32, exactly the values adoption installed."""
    out = {}
    for k, v in flat.items():
        if k.endswith(_I8S):
            continue
        if k.endswith(_I8):
            base = k[:-len(_I8)]
            out[base] = v.astype(np.float32) * flat[base + _I8S]
        elif k.endswith(_BF16):
            out[k[:-len(_BF16)]] = _bf16_decode(v)
        else:
            out[k] = v
    return out


def _flatten(tree: Dict, prefix: str = "") -> Dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
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


class AsyncCheckpointWriter:
    """Checkpoint writes on a background thread (``checkpoint.py:236-274``).

    ``submit(fn)`` waits for the previous submission, then runs ``fn`` on a
    thread; ``wait()`` joins it and re-raises the thread's error, so none
    is lost.  The engine hands ``fn`` a device snapshot of the state, not
    the live tensors: ``optimizer.step()`` updates in place, and a thread
    reading live tensors during the next finetune would write a torn
    checkpoint."""

    def __init__(self):
        self._thread = None
        self._error = None

    def submit(self, fn) -> None:
        self.wait()

        def _run():
            try:
                fn()
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def save_checkpoint(path: str, params: Dict, *,
                    bn_state: Optional[Dict] = None,
                    teacher_params: Optional[Dict] = None,
                    al_state: Optional[dict] = None,
                    opt_state: Optional[List] = None,
                    dtype: Optional[str] = None) -> None:
    """Atomic single-file checkpoint (tmpfile + rename).  ``params`` is a
    JAX-layout tree (``bridge.to_jax_params``, or the device tensors of
    ``bridge.to_jax_tensors``), and ``teacher_params`` the mean teacher's
    in the same form; ``opt_state`` the optax-ordered leaf list
    (``models.optim.opt_state_leaves`` / ``opt_state_tensors``).  ``dtype``
    is None/``float32``, ``bfloat16`` or ``int8``."""
    payload = _flatten(params, "params/")
    if bn_state:
        payload.update(_flatten(bn_state, "bn/"))
    if teacher_params:
        payload.update(_flatten(teacher_params, "teacher/"))
    for i, leaf in enumerate(opt_state or ()):
        payload[f"opt/{i:04d}"] = leaf
    if al_state is not None:
        payload["__al_state__"] = np.frombuffer(
            json.dumps(al_state).encode(), dtype=np.uint8)
    if dtype == "bfloat16":
        payload = _encode_bf16(payload)
    elif dtype == "int8":
        payload = _encode_int8(payload)
    elif dtype in (None, "float32"):
        payload = {k: _to_host(v) for k, v in payload.items()}
    else:
        raise ValueError(f"unsupported checkpoint dtype {dtype!r}")
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
    float32 leaves in the JAX layout — the JAX loader's contract; bf16 and
    int8 entries decode transparently."""
    with np.load(path, allow_pickle=False) as z:
        flat = _decode_flat({k: z[k] for k in z.files})
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
    """The checkpoint's ``opt/<i>`` leaves in order, decoded (empty if
    none)."""
    with np.load(path, allow_pickle=False) as z:
        flat = _decode_flat({k: z[k] for k in z.files
                             if k.startswith("opt/")})
    return [flat[k] for k in sorted(flat)]


def restore_opt_state(path: str, optimizer: torch.optim.Optimizer,
                      model: torch.nn.Module) -> torch.optim.Optimizer:
    """Re-attach a checkpoint's ``opt/<i>`` leaves to ``optimizer`` over
    ``model``'s parameters (``checkpoint.py:377-394``; JAX's takes a fresh
    optax state of the same structure, the port's the optimizer that
    holds it): a leaf count that does not fit raises ``ValueError``, and
    a checkpoint without optimizer leaves leaves it as it was.  Returns
    ``optimizer``."""
    from nnal_tpu_torch.models.optim import load_opt_state

    load_opt_state(optimizer, model, load_opt_leaves(path))
    return optimizer


def load_reference_h5(path: str, params_template: Dict) -> Dict:
    """Weights from the reference's HDF5 layout (``checkpoint.py:397-422``):
    a copy of the JAX-layout ``params_template`` (numpy) with each layer
    that the file holds replaced by its ``Weight`` (transposed when the
    file stores it feature-major) and ``Bias``; a shape that fits neither
    way raises ``ValueError``."""
    import h5py

    out = {layer: {k: np.asarray(v) for k, v in p.items()}
           for layer, p in params_template.items()}
    with h5py.File(path, "r") as f:
        for layer in f:
            if layer not in out:
                continue
            grp = f[layer]
            if "Weight" in grp:
                w = np.asarray(grp["Weight"])
                want = out[layer]["W"].shape
                if w.shape != want and w.T.shape == want:
                    w = w.T
                if w.shape != want:
                    raise ValueError(
                        f"{layer}/Weight shape {w.shape} vs {want}")
                out[layer]["W"] = w
            if "Bias" in grp:
                out[layer]["b"] = np.asarray(grp["Bias"]).reshape(
                    out[layer]["b"].shape)
    return out


def save_reference_h5(path: str, params: Dict) -> None:
    """Write JAX-layout ``params`` (numpy, or a port model's
    ``bridge.to_jax_params(model.state_dict())``) in the reference's HDF5
    layout (``checkpoint.py:425-435``): ``<layer>/Weight`` and
    ``<layer>/Bias``."""
    import h5py

    with h5py.File(path, "w") as f:
        for layer, vals in params.items():
            grp = f.create_group(layer)
            if "W" in vals:
                grp["Weight"] = np.asarray(vals["W"])
            if "b" in vals:
                grp["Bias"] = np.asarray(vals["b"])
