"""Sharded pool scoring and selection (counterpart of
``nnal_tpu/parallel/pool_sharded.py``).

Each selector scores its shard of the pool, keeps a local top-k, moves
the candidates to the primary device and takes the global top-k there
(the JAX package's ``all_gather`` of candidates, ``:25-338``).  Over a
single-process :class:`~nnal_tpu_torch.parallel.mesh.Mesh` one process
runs every shard, each on its device, and the candidates are copied to
the primary one; over a process mesh (``multihost.make_multihost_mesh``)
each process runs its own shard and ``all_gather`` over the data group
joins the candidates, so every process returns the same selection.

Ties keep the lower index first, as ``lax.top_k`` does
(``mesh.stable_topk``), in the local and in the global step: the pad
rows' ``-inf`` scores tie by design.

* :func:`make_sharded_pool_selector`: the raveled pool indices split over
  the shards, patches gathered by K2 (``ops/gather``) in chunks of
  ``ntb_per_shard``, scored by ``|p1 - 0.5|``, pad rows ``-inf``;
* :func:`make_sharded_grid_selector` / :func:`make_sharded_fim_grid_selector`:
  axial slices split over the shards (z padded to ``dp * z_inner``), each
  shard sweeping its block ``z_inner`` slices at a time by im2col with a
  top-k per step (the fused posterior + shrunk-gradient pass for fi);
* :func:`grid_row_to_voxel`, copied exactly;
* :func:`make_sharded_dense_segmenter`: stride-1 serving split by z, at a
  ``compute_dtype``.

The models and volumes are copied to each other shard device per call
(shards on one device share them).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nnal_tpu_torch.data.patches import gather_patches_normalized
from nnal_tpu_torch.ops.scoring_fused import pool_score_fused
from nnal_tpu_torch.parallel.mesh import (
    Replicas,
    gather_shards,
    local_shards,
    stable_topk,
)
from nnal_tpu_torch.scoring.grid_eval import extract_normalize
from nnal_tpu_torch.scoring.pool_eval import cast_input


def _stats(mu, sd, dev):
    return (torch.as_tensor(np.asarray(mu, np.float32)).to(dev),
            torch.as_tensor(np.asarray(sd, np.float32)).to(dev))


def _primary(mesh, shards):
    return mesh.primary if mesh.ranks is None else shards[0][1]


def make_sharded_pool_selector(mesh, patch_shape, orig_shape, k: int,
                               ntb_per_shard: int = 4096):
    """``run(model, padded, mu, sd, pool_inds) -> (scores, positions)``:
    the k most uncertain pool voxels across the mesh.  The pool is padded
    with index 0 to a multiple of the shard count; ``positions`` index
    that padded vector, and pad rows score ``-inf``."""
    dp = int(mesh.shape["data"])
    patch_shape, orig_shape = tuple(patch_shape), tuple(orig_shape)

    @torch.no_grad()
    def run(model, padded, mu, sd, pool_inds) -> Tuple[np.ndarray,
                                                       np.ndarray]:
        n = len(pool_inds)
        inds = np.concatenate([np.asarray(pool_inds, np.int64),
                               np.zeros(-n % dp, np.int64)])
        per = len(inds) // dp
        shards = local_shards(mesh)
        place = Replicas()
        parts = []
        for i, dev in shards:
            m, vol = place(model, dev), place(padded, dev)
            mu_d, sd_d = _stats(mu, sd, dev)
            ind = torch.as_tensor(inds[i * per:(i + 1) * per]).to(dev)
            unc = torch.cat([
                (m(gather_patches_normalized(vol, ind[c:c + ntb_per_shard],
                                             mu_d, sd_d, patch_shape,
                                             orig_shape)).posteriors[:, 1]
                 - 0.5).abs() for c in range(0, per, ntb_per_shard)])
            valid = torch.arange(per, device=dev) + i * per < n
            score = torch.where(valid, -unc, torch.full_like(unc,
                                                             -np.inf))
            vals, idx = stable_topk(score, k)
            parts.append((vals, idx + i * per))
        vals, gidx = gather_shards(mesh, parts, _primary(mesh, shards))
        top, pos = stable_topk(vals, k)
        return top.cpu().numpy(), gidx[pos].cpu().numpy()

    return run


def _grid_geometry(patch_shape, orig_shape, grid_spacing, dp, z_inner):
    d1, d2, d3 = (int(v) for v in patch_shape)
    if d3 != 1:
        raise ValueError("the sharded grid sweeps take d3 == 1 patches")
    s1, s2, s3 = (int(v) for v in orig_shape)
    g = int(grid_spacing)
    nx, ny = len(range(0, s1, g)), len(range(0, s2, g))
    z_pad = -s3 % (dp * z_inner)
    return d1, d2, g, nx, ny, s3, (s3 + z_pad) // dp


def _shard_block(padded, i, zc, s3, dev):
    """Shard ``i``'s ``zc`` axial slices ``(zc, m, D1p, D2p)`` on ``dev``,
    zero slices past ``s3``."""
    slices = padded.permute(3, 0, 1, 2)[i * zc:(i + 1) * zc]
    pad = zc - slices.shape[0]
    if pad:
        slices = torch.cat([slices, slices.new_zeros(
            (pad,) + tuple(slices.shape[1:]))])
    return slices.to(dev).contiguous()


def _grid_sweep_select(mesh, geometry, z_inner, k, score_step):
    """The shared loop of the two grid selectors: per shard and step,
    ``score_step(model, x) -> (score, extras)`` on the step's rows; pad
    slices score ``-inf``; per-step, then per-shard, then global top-k
    (ties to the lower grid row)."""
    d1, d2, g, nx, ny, s3, zc = geometry
    rows_per_step = z_inner * nx * ny

    def run(model, padded, mu, sd):
        shards = local_shards(mesh)
        place = Replicas()
        parts = []
        for i, dev in shards:
            m = place(model, dev)
            mu_d, sd_d = _stats(mu, sd, dev)
            block = _shard_block(padded, i, zc, s3, dev)
            row_z = torch.arange(rows_per_step, device=dev) // (nx * ny)
            cand = []
            for step in range(zc // z_inner):
                x = extract_normalize(
                    block[step * z_inner:(step + 1) * z_inner], d1, d2, g,
                    mu_d, sd_d)
                score, extras = score_step(m, x)
                live = row_z + step * z_inner + i * zc < s3
                score = torch.where(live, score,
                                    torch.full_like(score, -np.inf))
                vals, idx = stable_topk(score, k)
                cand.append((vals, idx + step * rows_per_step)
                            + tuple(e[idx] for e in extras))
            cols = [torch.cat(c) for c in zip(*cand)]
            vals, pos = stable_topk(cols[0], k)
            parts.append((vals, cols[1][pos] + i * zc * nx * ny)
                         + tuple(c[pos] for c in cols[2:]))
        cols = gather_shards(mesh, parts, _primary(mesh, shards))
        top, pos = stable_topk(cols[0], k)
        return (top.cpu().numpy(),) + tuple(c[pos].cpu().numpy()
                                            for c in cols[1:])

    return run


def make_sharded_grid_selector(mesh, patch_shape, orig_shape,
                               grid_spacing: int, k: int, z_inner: int = 2):
    """Sharded im2col grid sweep: ``run(model, padded, mu, sd) ->
    (scores, grid_rows)``, the k most uncertain grid rows (z-major, ``(z *
    nx + gx) * ny + gy`` over the full grid), scored ``-|p1 - 0.5|``."""
    geometry = _grid_geometry(patch_shape, orig_shape, grid_spacing,
                              int(mesh.shape["data"]), z_inner)

    @torch.no_grad()
    def score_step(model, x):
        p1 = model(x, nchw=True).posteriors[:, 1]
        return -(p1 - 0.5).abs(), ()

    return _grid_sweep_select(mesh, geometry, z_inner, k, score_step)


def make_sharded_fim_grid_selector(mesh, patch_shape, orig_shape,
                                   grid_spacing: int, B: int,
                                   z_inner: int = 2, compute_dtype=None):
    """Sharded fused posterior + FIM grid sweep (fi's device stage):
    ``run(model, padded, mu, sd) -> (scores, grid_rows, p1, shrunk)``, the
    top B by uncertainty with their posteriors and (B, c, L) shrunk class
    gradients, sorted by descending score.  The host's A-matrices, SDP
    and PMF follow as on one device."""
    geometry = _grid_geometry(patch_shape, orig_shape, grid_spacing,
                              int(mesh.shape["data"]), z_inner)

    def score_step(model, x):
        out = pool_score_fused(model, x, True, compute_dtype, nchw=True)
        return -out["uncertainty"], (out["p1"], out["shrunk"])

    return _grid_sweep_select(mesh, geometry, z_inner, B, score_step)


def grid_row_to_voxel(rows, orig_shape, grid_spacing: int) -> np.ndarray:
    """Map full-grid row ids (z-major) back to raveled voxel indices."""
    s1, s2, s3 = orig_shape
    g = int(grid_spacing)
    nx = len(range(0, s1, g))
    ny = len(range(0, s2, g))
    rows = np.asarray(rows, np.int64)
    gy = rows % ny
    rem = rows // ny
    gx = rem % nx
    z = rem // nx
    return (gx * g * s2 + gy * g) * s3 + z


def make_sharded_dense_segmenter(mesh, patch_shape, orig_shape,
                                 op: str = "posteriors", z_inner: int = 1,
                                 compute_dtype=None):
    """Mesh-sharded whole-volume segmentation (serving): axial slices split
    over the shards, each running the stride-1 im2col sweep of
    ``evaluation/inference.full_volume_patchwise`` over its block,
    ``z_inner`` slices a step.  ``run(model, padded, mu, sd) -> (s1, s2,
    s3)`` array of ``op`` ('posteriors': P(class 1) of a binary spec;
    'prediction')."""
    d1, d2, _, _, _, s3, zc = _grid_geometry(
        patch_shape, orig_shape, 1, int(mesh.shape["data"]), z_inner)
    s1, s2, _ = (int(v) for v in orig_shape)

    @torch.no_grad()
    def run(model, padded, mu, sd) -> np.ndarray:
        shards = local_shards(mesh)
        place = Replicas()
        parts = []
        for i, dev in shards:
            m = place(model, dev)
            mu_d, sd_d = _stats(mu, sd, dev)
            block = _shard_block(padded, i, zc, s3, dev)
            vals = []
            for step in range(zc // z_inner):
                x = cast_input(extract_normalize(
                    block[step * z_inner:(step + 1) * z_inner], d1, d2, 1,
                    mu_d, sd_d), compute_dtype)
                out = m(x, nchw=True)
                vals.append(out.prediction if op == "prediction" else
                            out.posteriors[:, 1] if m.spec.nclass == 2
                            else out.posteriors)
            parts.append((torch.cat(vals),))
        (flat,) = gather_shards(mesh, parts, _primary(mesh, shards))
        flat = flat[:s3 * s1 * s2].cpu().numpy()
        # the sweep's layout is (z, x, y); the volume's (x, y, z)
        return np.moveaxis(flat.reshape((s3, s1, s2) + flat.shape[1:]),
                           0, 2)

    return run
