"""Grid-pool evaluation via im2col (counterpart of
``nnal_tpu/scoring/grid_eval.py``).

AL pools are regular grids over axial slices, and extracting every grid
window of a slice is ``F.unfold`` (im2col): strided copies instead of
per-patch gathers.  :class:`GridPoolEvaluator` sweeps the grid z-chunk by
z-chunk (extract -> normalize -> forward) and selects the rows the caller
asked for; off-grid indices route to a stride-1 slab sweep when that is
cheaper, else to the per-patch gather of :class:`PoolEvaluator` (kernel K2
on the card).  Multi-slice patches (``d3 > 1``, odd) ride the same 2-D
im2col by stacking each voxel's z-neighbours as channels, modality-major
like the gather's ``(b, d1, d2, m*d3)`` layout.  ``fim_sweep`` scores the
whole grid with the fused posterior + diag-FIM pass and ``perturb_sweep``
with AU_4U's output-perturbation divergence.  im2col and normalization
stay f32 and a bf16 ``compute_dtype`` cast follows them
(``grid_eval.py:72-76``).

Stochastic sweeps (MC dropout, perturbation noise) key each z-chunk's
generator on the chunk's global index, as the JAX package folds
``step_base + step`` into its key (``grid_eval.py:78``): a slab
evaluation that starts at chunk c draws what the whole sweep draws for
chunk c, so both routes give the same rows bit for bit.  Their ragged last
chunk is zero-padded to ``z_chunk`` slices, as JAX pads the slice stack,
so every chunk's draws have one shape; so is an int8-quantized model's,
whose per-tensor activation scales JAX takes over the padded chunk.  The
stride-1 clone of the off-grid route keeps its own chunking, as in JAX.
The whole-grid sweeps (``evaluate``'s whole sweep, ``fim_sweep``,
``perturb_sweep``) take their chunks from ``_shards``: here every chunk
on this evaluator's device; ``parallel/grid_sharded`` splits them over a
mesh's devices.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from nnal_tpu_torch.core import rng as core_rng
from nnal_tpu_torch.models.perturb import measure_output_perturbation
from nnal_tpu_torch.models.quant import is_quantized
from nnal_tpu_torch.ops.scoring_fused import pool_score_fused
from nnal_tpu_torch.scoring.pool_eval import (
    PoolEvaluator,
    cast_input,
    select_output,
    to_host,
)

# ops whose per-patch output is wide: the host path pulls them slab by slab
_WIDE_OPS = {"feature_layer", "logits"}

# off-grid index sets take a stride-1 slab sweep when it is this many times
# cheaper per patch than the gather (the JAX package's routing margin)
_DENSE_OFFGRID_RATIO = 6


def extract_normalize(blk, d1, d2, g, mu, sd) -> torch.Tensor:
    """im2col of ``blk`` (zc, C, D1p, D2p) at stride ``g`` + per-channel
    normalization.  Returns ``(zc*nx*ny, C, d1, d2)`` rows in z-major grid
    order; ``F.unfold`` emits channel-major (c, kh, kw) features, as
    ``conv_general_dilated_patches`` does.  ``mu``/``sd`` span the C
    channels (depth-repeated for d3 > 1)."""
    c = blk.shape[1]
    cols = F.unfold(blk, (d1, d2), stride=g)          # (zc, C*d1*d2, L)
    x = cols.transpose(1, 2).reshape(-1, c, d1, d2)
    return (x - mu[:, None, None]) / sd[:, None, None]


class GridPoolEvaluator(PoolEvaluator):
    """Pool evaluator specialized for grid-sampled pools."""

    def __init__(self, spec, padded, mu, sd, patch_shape, orig_shape,
                 grid_spacing: int, ntb: int = 4096, z_chunk: int = 4,
                 compute_dtype=None):
        super().__init__(spec, padded, mu, sd, patch_shape, orig_shape,
                         ntb=ntb, compute_dtype=compute_dtype)
        self.grid_spacing = int(grid_spacing)
        self.z_chunk = int(z_chunk)
        s1, s2, s3 = self.orig_shape
        self.nx = len(range(0, s1, self.grid_spacing))
        self.ny = len(range(0, s2, self.grid_spacing))
        self.nz = s3
        d3 = self.patch_shape[2]
        # even depths cannot sweep: the gather clamps the last z's window,
        # which a channel stack cannot reproduce — every evaluate of an
        # even-d3 evaluator takes the exact gather path
        self._sweep_ok = d3 % 2 == 1
        self._slices = None
        if d3 == 1:
            # (D3, m, D1p, D2p) slice stack, device-resident
            self._slices = self.padded.permute(3, 0, 1, 2).contiguous()
        elif self._sweep_ok:
            # slice z's channel j*d3 + t is modality j at depth z + t
            p = self.padded                              # (m, D1p, D2p, D3p)
            views = torch.stack([p[..., t:t + s3] for t in range(d3)],
                                dim=1)                   # (m, d3, D1p, D2p, s3)
            self._slices = views.permute(4, 0, 1, 2, 3).reshape(
                (s3, p.shape[0] * d3) + tuple(p.shape[1:3])).contiguous()
        self._mu_c = self.mu.repeat_interleave(d3)
        self._sd_c = self.sd.repeat_interleave(d3)
        # the first slice ``_slices`` holds (a shard's stack starts later)
        self._z_base = 0

    def _block(self, step: int, padded: bool):
        """Z-chunk ``step`` of the slice stack; with ``padded`` (stochastic
        and int8 sweeps) a ragged last chunk is zero-padded to ``z_chunk``
        slices."""
        z0 = step * self.z_chunk - self._z_base
        block = self._slices[z0:z0 + self.z_chunk]
        pad = self.z_chunk - block.shape[0]
        if padded and pad:
            block = torch.cat([block, block.new_zeros(
                (pad,) + tuple(block.shape[1:]))])
        return block

    def _extract(self, block):
        d1, d2, _ = self.patch_shape
        x = extract_normalize(block, d1, d2, self.grid_spacing, self._mu_c,
                              self._sd_c)
        return cast_input(x, self.compute_dtype)

    def _sweep_block(self, model, step, ops, mc_rng=None):
        """Chunk ``step``'s outputs; with ``mc_rng`` dropout is on, drawn
        from the chunk's own generator."""
        mc = mc_rng is not None
        gen = (core_rng.key_generator(mc_rng, step, self.device)
               if mc else None)
        pad = mc or is_quantized(model)
        out = model(self._extract(self._block(step, pad)), nchw=True,
                    mc_dropout=mc, generator=gen)
        return [select_output(out, op, self.spec.nclass) for op in ops]

    def _n_steps(self) -> int:
        return -(-self.nz // self.z_chunk)

    def _shards(self, *models):
        """Where the whole-grid sweeps run: ``(evaluator, models, steps)``
        per device, each evaluator holding the slices of its z-chunk
        ``steps`` and the models on its device.  Here one entry, every
        chunk on this evaluator's device; the mesh-sharded subclass
        (``parallel/grid_sharded``) splits the chunks over its devices."""
        return [(self, models, range(self._n_steps()))]

    def _require_sweep(self) -> None:
        """The whole-grid sweeps' guard: even depths cannot sweep."""
        if not self._sweep_ok:
            raise ValueError(
                f"d3={self.patch_shape[2]} is even: the channel-stacked "
                "sweep cannot reproduce the clamped gather at the volume "
                "border")

    def _grid_rows(self, inds: np.ndarray):
        """Raveled voxel indices -> full-grid row ids, or None if any index
        is off-grid."""
        _, s2, s3 = self.orig_shape
        g = self.grid_spacing
        inds = np.asarray(inds, np.int64)
        z = inds % s3
        rem = inds // s3
        y = rem % s2
        x = rem // s2
        if np.any(x % g) or np.any(y % g):
            return None
        return (z * self.nx + x // g) * self.ny + y // g

    def with_spacing(self, grid_spacing: int) -> "GridPoolEvaluator":
        """Clone at another grid spacing (e.g. stride 1) sharing the device
        volumes; the z-chunk shrinks so rows per chunk stay about equal."""
        ev = GridPoolEvaluator.__new__(GridPoolEvaluator)
        ev.__dict__.update(self.__dict__)
        ev.grid_spacing = int(grid_spacing)
        s1, s2, _ = self.orig_shape
        ev.nx = len(range(0, s1, ev.grid_spacing))
        ev.ny = len(range(0, s2, ev.grid_spacing))
        ev.z_chunk = max(1, (self.z_chunk * self.nx * self.ny)
                         // (ev.nx * ev.ny))
        return ev

    def _offgrid_dense_worthwhile(self, inds: np.ndarray) -> bool:
        """True when a stride-1 slab sweep over the touched z-slabs beats
        per-patch gathers for this off-grid index set."""
        if len(inds) == 0:
            return False
        s1, s2, s3 = self.orig_shape
        slabs = len(np.unique((np.asarray(inds, np.int64) % s3)
                              // self.z_chunk))
        return (len(inds) * _DENSE_OFFGRID_RATIO
                > slabs * s1 * s2 * self.z_chunk)

    def _eval_slabs(self, model, rows: np.ndarray, ops, mc_rng=None
                    ) -> Dict[str, np.ndarray]:
        """One z-chunk sweep per slab that holds requested rows; the rows
        are selected on the device so only they reach the host.  MC keys
        fold the slab's global chunk id, so the rows equal the whole
        sweep's bit for bit."""
        rows = np.asarray(rows, np.int64)
        slab_rows = self.nx * self.ny * self.z_chunk
        slab_ids = rows // slab_rows
        results: Dict[str, np.ndarray] = {}
        for slab in np.unique(slab_ids):
            sel = np.nonzero(slab_ids == slab)[0]
            local = torch.as_tensor(rows[sel] - slab * slab_rows).to(
                self.device)
            outs = self._sweep_block(model, int(slab), ops, mc_rng)
            for op, o in zip(ops, outs):
                arr = o[local].cpu().numpy()
                if op not in results:
                    results[op] = np.empty((len(rows),) + arr.shape[1:],
                                           arr.dtype)
                results[op][sel] = arr
        return results

    def _whole_sweep(self, model, ops, mc_rng=None):
        """Every grid row, one z-chunk at a time; one tensor per op with
        ``nz*nx*ny`` rows in grid order (a padded MC chunk's extra rows
        trail)."""
        parts = [ev._sweep_block(m, step, ops, mc_rng)
                 for ev, (m,), steps in self._shards(model) for step in steps]
        return [torch.cat([p[i].to(self.device) for p in parts])
                for i in range(len(ops))]

    @torch.no_grad()
    def evaluate(self, model, pool_inds, ops: Sequence[str] = ("posteriors",),
                 as_device: bool = False, *, mc_rng=None) -> Dict:
        ops = tuple(ops)
        rows = self._grid_rows(pool_inds) if self._sweep_ok else None
        if rows is None:
            if not as_device and self._sweep_ok \
                    and self._offgrid_dense_worthwhile(pool_inds):
                ev1 = self if self.grid_spacing == 1 else self.with_spacing(1)
                return ev1.evaluate(model, pool_inds, ops, mc_rng=mc_rng)
            return super().evaluate(model, pool_inds, ops, as_device,
                                    mc_rng=mc_rng)
        if not as_device and len(rows):
            n_slabs = self._n_steps()
            needed = len(np.unique(np.asarray(rows, np.int64)
                                   // (self.nx * self.ny * self.z_chunk)))
            # wide ops always slab; narrow ones only when at least half the
            # slabs can be skipped
            if (set(ops) & _WIDE_OPS) or needed <= n_slabs // 2:
                return self._eval_slabs(model, rows, ops, mc_rng)
        outs = self._whole_sweep(model, ops, mc_rng)
        rows_d = torch.as_tensor(np.asarray(rows, np.int64)).to(self.device)
        return to_host({op: o[rows_d] for op, o in zip(ops, outs)},
                       as_device)

    def fim_sweep(self, model, compute_dtype=None, as_device: bool = False
                  ) -> Dict:
        """Posterior + diag-FIM ingredients for the WHOLE grid, one z-chunk
        at a time (extract -> normalize -> ``pool_score_fused``).  Returns
        ``{"p1", "uncertainty", "shrunk"}`` of length nz*nx*ny in grid
        order (z-major), as host arrays or, with ``as_device``, tensors.
        ``compute_dtype=None`` takes the evaluator's own (``:286-287``)."""
        self._require_sweep()
        cd = (compute_dtype if compute_dtype is not None
              else self.compute_dtype)
        d1, d2, _ = self.patch_shape
        parts = []
        for ev, (m,), steps in self._shards(model):
            for step in steps:
                x = extract_normalize(ev._block(step, False), d1, d2,
                                      self.grid_spacing, ev._mu_c, ev._sd_c)
                parts.append(pool_score_fused(m, x, True, cd, nchw=True))
        return to_host({k: torch.cat([p[k].to(self.device) for p in parts])
                        for k in ("p1", "uncertainty", "shrunk")}, as_device)

    @torch.no_grad()
    def perturb_sweep(self, model, rng, teacher=None, measure: str = "CE",
                      gaussian_std=0.05, rotation_angle=None,
                      as_device: bool = False):
        """AU_4U divergence for the WHOLE grid (``_grid_perturb_sweep``):
        one :func:`measure_output_perturbation` per z-chunk at the
        evaluator's compute dtype, its noise drawn from the chunk's own
        generator (key ``rng``, tag the chunk's index).  Length
        ``nz*nx*ny``, grid order."""
        self._require_sweep()
        parts = []
        for ev, (m, t), steps in self._shards(model, teacher):
            for step in steps:
                x = ev._extract(ev._block(step, True))
                gen = core_rng.key_generator(rng, step, ev.device)
                parts.append(measure_output_perturbation(
                    m, x, gen, teacher=t, measure=measure,
                    gaussian_std=gaussian_std,
                    rotation_angle=rotation_angle, nchw=True).to(self.device))
        divs = torch.cat(parts)[:self.nz * self.nx * self.ny]
        return divs if as_device else divs.cpu().numpy()
