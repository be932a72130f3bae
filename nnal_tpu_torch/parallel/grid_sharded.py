"""The z-sharded grid-pool evaluator (counterpart of
``nnal_tpu/parallel/grid_sharded.py``): what the ``data_parallel`` config
key turns on in both patch-wise engines.

:class:`ShardedGridPoolEvaluator` is a drop-in for
``scoring/grid_eval.GridPoolEvaluator`` whose whole-grid sweeps
(``evaluate``'s whole-sweep path, ``fim_sweep``, ``perturb_sweep``) run
over the mesh's data shards.  z pads to ``dp * z_chunk`` (``_pad_mult``,
``grid_sharded.py:72-76``), so chunk boundaries are the single-device
sweep's: shard ``i`` takes a contiguous run of z-chunks, and its slices
are placed on its device once, at construction (the volumes do not change
during a campaign).  Each shard runs the very chunk programs the
single-device sweep runs (the same slices, the same ragged last chunk,
MC-dropout and perturbation generators keyed on the chunk's GLOBAL
index), so its rows are the single-device rows bit for bit; they come back
to the evaluator's own (primary) device in grid order.  The model (and
AU_4U's teacher) is copied to each other device once per sweep; shards on
one device share it.

The subclass overrides one seam, ``GridPoolEvaluator._shards`` ("which
chunks, on which device"); the loops, the pad and trim bookkeeping and
the slab pulls stay in ``grid_eval.py``.  The slab-restricted host pulls
and the off-grid gathers stay single-device, as in JAX (``:29-33``), and
so does the finetune.  ``bytes_moved`` counts the bytes this evaluator
copied between devices (slices and model copies; the per-row outputs
that come back to the primary device are not counted).
"""

from __future__ import annotations

import torch

from nnal_tpu_torch.parallel.mesh import Replicas
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator

__all__ = ["ShardedGridPoolEvaluator"]


class ShardedGridPoolEvaluator(GridPoolEvaluator):
    """GridPoolEvaluator whose whole-grid sweeps shard over ``mesh``."""

    def __init__(self, mesh, *args, **kw):
        super().__init__(*args, **kw)
        self.mesh = mesh
        self._dp = int(mesh.shape["data"])
        self.bytes_moved = 0
        self._shard_evs = []
        if self._slices is None:           # even d3: no sweep to shard
            return
        n = self._n_steps()
        per = -(-n // self._dp)            # z-chunks a shard: z pads to
        place = Replicas()                 # dp * z_chunk
        for i, dev in enumerate(mesh.data_devices):
            steps = range(min(i * per, n), min((i + 1) * per, n))
            if len(steps):
                self._shard_evs.append((self._shard(dev, steps, place),
                                        steps))
        self.bytes_moved = place.bytes_moved

    def _shard(self, dev, steps, place) -> GridPoolEvaluator:
        """A plain evaluator over the slices of z-chunks ``steps`` on
        ``dev`` (a view when ``dev`` is this evaluator's device)."""
        ev = GridPoolEvaluator.__new__(GridPoolEvaluator)
        ev.__dict__.update(self.__dict__)
        for k in ("mesh", "_dp", "bytes_moved", "_shard_evs"):
            ev.__dict__.pop(k, None)
        z0 = steps.start * self.z_chunk
        z1 = min(steps.stop * self.z_chunk, self.nz)
        ev._z_base = z0
        ev.device = torch.device(dev)
        ev._slices = place(self._slices[z0:z1], dev).contiguous()
        ev._mu_c = place(self._mu_c, dev)
        ev._sd_c = place(self._sd_c, dev)
        return ev

    def _shards(self, *models):
        if not self._shard_evs:
            return super()._shards(*models)
        place = Replicas()                 # the weights change per sweep
        shards = [(ev, tuple(place(m, ev.device) for m in models), steps)
                  for ev, steps in self._shard_evs]
        self.bytes_moved += place.bytes_moved
        return shards
