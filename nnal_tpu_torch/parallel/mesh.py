"""Device meshes (counterpart of ``nnal_tpu/parallel/mesh.py``).

A :class:`Mesh` is a ``(data, model)`` grid of ``torch.device``s: ``data``
shards pools and batches, ``model`` splits the fc stack (``sharding.py``).
``mesh.shape["data"]`` and ``mesh.shape["model"]`` read as in JAX.  A mesh
of one process over its own devices (:func:`make_mesh`) drives the
single-controller paths: the z-sharded evaluator (``grid_sharded.py``) and
the pool selectors (``pool_sharded.py``) run each shard's chunks on its
device and join the outputs on the primary one.  A mesh that also holds
each cell's process rank (``multihost.make_multihost_mesh``) drives the
process-group paths instead: every process runs its own cell, and
``torch.distributed`` joins them.

On CUDA, :func:`make_mesh` takes ``n_devices`` distinct cards and raises,
naming the count it found, when there are fewer: it never drops to the
CPU backend as the JAX package's does (``mesh.py:31-35``), which would
hide the device.  ``device="cpu"`` gives ``n_devices`` CPU shards (the
counterpart of the JAX tests' virtual CPU mesh), and an explicit device
list is taken as given, repeats included (one card twice is a 2-shard
mesh on a one-card machine).
"""

from __future__ import annotations

import copy
import functools as _functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nnal_tpu_torch.core.device import resolve_device


def _indexed(device) -> torch.device:
    """``device`` with its card's index (``cuda`` alone is the current
    card), so it compares equal to a tensor's ``.device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A ``(data, model)`` grid of devices; ``ranks``, when given, is the
    same grid of process ranks (one process per cell)."""

    def __init__(self, devices, ranks=None):
        devs = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(devs.shape):
            devs[idx] = _indexed(np.asarray(devices, dtype=object)[idx])
        self.devices = devs
        self.ranks = None if ranks is None else np.asarray(ranks, np.int64)
        dp, mp = devs.shape
        self.shape = {"data": int(dp), "model": int(mp)}
        self._groups = None

    def group(self, axis: str):
        """This process's ``torch.distributed`` group along ``axis``
        (``data``: the cells of its model column, ``model``: of its data
        row).  Every process creates every group, in one order, on its
        first call (``new_group``'s rule)."""
        if self._groups is None:
            dp, mp = self.ranks.shape
            self._groups = {
                "data": [dist.new_group(self.ranks[:, j].tolist())
                         for j in range(mp)],
                "model": [dist.new_group(self.ranks[i, :].tolist())
                          for i in range(dp)]}
        d, m = self.coords(dist.get_rank())
        return self._groups[axis][m if axis == "data" else d]

    @property
    def primary(self) -> torch.device:
        return self.devices[0, 0]

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """One device per data shard (the first of its model row)."""
        return tuple(self.devices[:, 0])

    def coords(self, rank: int) -> Tuple[int, int]:
        """``(data, model)`` index of a process rank's cell."""
        if self.ranks is None:
            raise ValueError("this mesh holds no process ranks")
        d, m = np.argwhere(self.ranks == rank)[0]
        return int(d), int(m)


def default_mesh_shape(n_devices: int, model_parallel: int = 1
                       ) -> Tuple[int, int]:
    """(data, model) factorization; model axis must divide n_devices."""
    if n_devices % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide "
                         f"{n_devices}")
    return n_devices // model_parallel, model_parallel


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device=None) -> Mesh:
    """A mesh of ``n_devices`` devices: distinct cards by default (all of
    them when ``n_devices`` is None), ``n_devices`` CPU shards with
    ``device="cpu"``, or an explicit list of devices."""
    if isinstance(device, (list, tuple)):
        devices = [torch.device(d) for d in device]
        if n_devices is not None and len(devices) != n_devices:
            raise ValueError(f"need {n_devices} devices, the list holds "
                             f"{len(devices)}")
    else:
        dev = resolve_device(device)
        if dev.type == "cuda":
            found = torch.cuda.device_count()
            n = found if n_devices is None else int(n_devices)
            if found < n:
                raise ValueError(
                    f"need {n} CUDA devices, found {found}; pass an "
                    "explicit device list to place several shards on one "
                    "card")
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            devices = [dev] * (1 if n_devices is None else int(n_devices))
    dp, mp = default_mesh_shape(len(devices), model_parallel)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, mp))


@_functools.lru_cache(maxsize=None)
def _cached(n_devices, model_parallel, device) -> Mesh:
    return make_mesh(n_devices, model_parallel, device)


def cached_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
                device=None) -> Mesh:
    """Memoized :func:`make_mesh`: the engines resolve ``data_parallel``
    through this, so every evaluator of a size shares one mesh."""
    if isinstance(device, list):
        device = tuple(device)
    if isinstance(device, tuple):
        device = tuple(str(torch.device(d)) for d in device)
    elif device is not None:
        device = str(torch.device(device))
    return _cached(n_devices, model_parallel, device)


class Replicas:
    """Copies of models and tensors on shard devices, one per (object,
    device), made on first use; an object already on the device is used
    as is.  ``bytes_moved`` counts what was copied."""

    def __init__(self):
        self._cache = {}
        self.bytes_moved = 0

    def __call__(self, obj, dev):
        if obj is None:
            return None
        dev = _indexed(dev)
        tensors = ([obj] if isinstance(obj, torch.Tensor)
                   else list(obj.state_dict().values()))
        if not tensors or tensors[0].device == dev:
            return obj
        key = (id(obj), dev)
        if key not in self._cache:
            self.bytes_moved += sum(t.numel() * t.element_size()
                                    for t in tensors)
            self._cache[key] = (obj.to(dev) if isinstance(obj, torch.Tensor)
                                else copy.deepcopy(obj).to(dev))
        return self._cache[key]


def stable_topk(scores: torch.Tensor, k: int):
    """The ``k`` largest ``scores`` and their positions, equal scores
    lower position first: ``lax.top_k``'s order, which ``torch.topk`` does
    not promise (the ``-inf`` of pad rows tie by design)."""
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return vals[:k], idx[:k]


def local_shards(mesh: Mesh) -> List[Tuple[int, torch.device]]:
    """``(data index, device)`` of the shards this process runs: every
    data shard of a single-process mesh, or this process's own cell."""
    if mesh.ranks is None:
        return list(enumerate(mesh.data_devices))
    d, m = mesh.coords(dist.get_rank())
    return [(d, mesh.devices[d, m])]


def gather_shards(mesh: Mesh, parts: Sequence[Sequence[torch.Tensor]],
                  device) -> Tuple[torch.Tensor, ...]:
    """Data-shard-major concatenation on ``device`` of each shard's
    tensors (``parts``: one tuple per shard this process ran, in data
    order): a copy and ``cat`` on a single-process mesh, an ``all_gather``
    over the data group on a process mesh.  The counterpart of
    ``all_gather(..., tiled=True)``."""
    if mesh.ranks is None:
        return tuple(torch.cat([p[i].to(device) for p in parts])
                     for i in range(len(parts[0])))
    (own,) = parts
    out = []
    for t in own:
        bufs = [torch.empty_like(t) for _ in range(mesh.shape["data"])]
        dist.all_gather(bufs, t.contiguous(), group=mesh.group("data"))
        out.append(torch.cat(bufs).to(device))
    return tuple(out)
