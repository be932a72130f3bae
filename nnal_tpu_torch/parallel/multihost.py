"""Multi-process runtime (counterpart of ``nnal_tpu/parallel/multihost.py``):
``torch.distributed`` initialization and a process-spanning mesh.

Each process (one per card, or one per CPU shard) calls
:func:`init_distributed` with the coordinator's ``host:port``, the
process count and its own rank: ``nccl`` on the card, ``gloo`` on the CPU,
a ``tcp://`` init method, and idempotent.  Nothing on a machine announces
a cluster, so the caller always names all three.
:func:`make_multihost_mesh` lays the processes out as a ``(data, model)``
grid with the host outermost, as JAX's does (``:41-61``): the model axis
never spans hosts, so its per-layer collectives stay on one host and the
data axis carries one gradient reduction a step across hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nnal_tpu_torch.core.device import resolve_device
from nnal_tpu_torch.parallel.mesh import Mesh


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int,
                     local_device_ids: Optional[Sequence[int]] = None,
                     device=None) -> None:
    """Join the process group; a no-op once joined.  ``device`` None or
    CUDA: ``nccl``, on card ``local_device_ids[0]`` (default: the rank
    modulo the visible cards); ``"cpu"``: ``gloo``."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        ids = (list(local_device_ids) if local_device_ids
               else [process_id % torch.cuda.device_count()])
        torch.cuda.set_device(ids[0])
    addr = str(coordinator_address)
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=addr if addr.startswith("tcp://") else f"tcp://{addr}",
        world_size=int(num_processes), rank=int(process_id))


def _world() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_multihost_mesh(model_parallel: int = 1,
                        processes_per_host: Optional[int] = None,
                        device=None) -> Mesh:
    """The process mesh ``(world / model_parallel, model_parallel)``, rank
    order, hosts outermost; each cell holds its process's device (this
    process's current card, another's card by its host-local index, or
    the CPU).  ``processes_per_host`` defaults to the whole world (one
    host).  Works unchanged in a single process."""
    _, world = _world()
    n_local = world if processes_per_host is None else int(processes_per_host)
    if model_parallel > n_local:
        raise ValueError(
            f"model_parallel={model_parallel} would span hosts "
            f"({n_local} processes a host); the model axis stays on a host")
    if n_local % model_parallel or world % n_local:
        raise ValueError(f"model_parallel={model_parallel} must divide "
                         f"the {n_local} processes of a host, and they "
                         f"the world of {world}")
    rank, _ = _world()
    dev = resolve_device(device)
    devices = np.empty(world, dtype=object)
    for r in range(world):
        devices[r] = dev
        if dev.type == "cuda":
            devices[r] = torch.device("cuda", torch.cuda.current_device()
                                      if r == rank else r % n_local
                                      % torch.cuda.device_count())
    shape = (world // model_parallel, model_parallel)
    return Mesh(devices.reshape(shape), ranks=np.arange(world).reshape(shape))


def process_local_pool_slice(n_pool: int) -> Tuple[int, int]:
    """[lo, hi) of the global pool owned by this process — hosts feed only
    their own shard (per-host IO, no cross-host data movement before the
    candidate all-gather)."""
    pid, nproc = _world()
    per = -(-n_pool // nproc)
    lo = min(pid * per, n_pool)
    return lo, min(lo + per, n_pool)
