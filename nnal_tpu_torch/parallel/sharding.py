"""Sharded training and pool top-k over ``torch.distributed`` process
groups (counterpart of ``nnal_tpu/parallel/sharding.py``).

One process per cell of a process mesh (``multihost.make_multihost_mesh``):

* **DP**: each data row holds its slice of the global batch; after the
  backward every gradient is summed over the data group (an
  ``all_reduce``), the loss being the global batch mean (over every
  pixel of a dense spec's per-pixel CE), so each process takes the step
  GSPMD derives from JAX's ``P("data")`` batch.  Train-mode batch norm
  normalizes by the GLOBAL batch's statistics, as GSPMD computes them for
  that batch: each process's per-channel mean, then its mean of squares
  centered on the global mean, are averaged over the data group by an
  ``all_reduce`` whose backward is an ``all_reduce`` of the gradient, so
  the gradient flows through the collective.  JAX's step passes no BN
  state, so no running statistics move.
* **TP**: the spec-CNN fc stack splits as JAX's PartitionSpecs say
  (``sharding.py:32-35``): ``fc1`` column-parallel (its output features:
  weight dim 0 of torch's ``(out, in)`` layout, and its bias), ``fc2``
  row-parallel (weight dim 1, its input features), everything else
  replicated.  The collectives GSPMD inserts are explicit here, Megatron's
  pair: ``fc1``'s input is the identity forward and an ``all_reduce`` of
  its gradient backward over the model group; ``fc2``'s partial products
  are ``all_reduce``d forward (identity backward) before its bias.  A
  model axis of 1 runs every layer as the module's own forward.
* :func:`sharded_pool_topk`: a local top-k per shard, an ``all_gather``
  of the candidates over the data group and a global top-k (ties to the
  lower index, as ``lax.top_k``).

The forward is ``CNN.forward`` itself with a :class:`_Shard` (the
split fc layers' main op, the BN reduction, the dropout cut), so skip
sources, batch norm, transposed convs and 3-D specs run as they do in one
process.  Dropout draws the GLOBAL batch's uniforms through
``models/cnn._dropout_uniform`` (the seam the tests feed JAX's draws
through) and each process keeps its rows, and ``fc1``'s its columns, so
the masks are the single-process step's.
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from nnal_tpu_torch.core import rng as core_rng
from nnal_tpu_torch.core.device import set_precision
from nnal_tpu_torch.models import cnn as cnn_mod
from nnal_tpu_torch.parallel.mesh import (
    gather_shards,
    local_shards,
    stable_topk,
)

# the TP plan: layer -> {parameter: the dim split over the model axis}
_TP_FC_PLAN = {"fc1": {"weight": 0, "bias": 0}, "fc2": {"weight": 1}}


def param_partition_specs(params, tensor_parallel: bool = True
                          ) -> Dict[str, Optional[int]]:
    """``{parameter name: dim split over the model axis, or None}`` for a
    module or a ``{name: tensor or shape}`` mapping: the fc stack per the
    TP plan, everything else replicated."""
    names = (list(params) if isinstance(params, Mapping)
             else [n for n, _ in params.named_parameters()])
    specs = {}
    for name in names:
        layer, _, leaf = name.rpartition(".")
        specs[name] = (_TP_FC_PLAN.get(layer, {}).get(leaf)
                       if tensor_parallel else None)
    return specs


def spec_params_template(spec) -> Dict[str, torch.Size]:
    """Parameter shapes of ``spec``'s network, without materializing its
    weights (a meta-device module)."""
    with torch.device("meta"):
        model = cnn_mod.CNN(spec)
    return {n: p.shape for n, p in model.named_parameters()}


def _cell(mesh):
    d, m = mesh.coords(dist.get_rank())
    return d, m, mesh.devices[d, m]


def shard_params(model: torch.nn.Module, mesh,
                 tensor_parallel: bool = True) -> torch.nn.Module:
    """This process's copy of ``model`` on its cell's device, its TP
    parameters cut to the cell's slice of the model axis."""
    _, m, dev = _cell(mesh)
    mp = int(mesh.shape["model"])
    local = copy.deepcopy(model).to(dev)
    specs = param_partition_specs(local, tensor_parallel)
    with torch.no_grad():
        for name, p in local.named_parameters():
            dim = specs[name]
            if dim is None or mp == 1:
                continue
            if p.shape[dim] % mp:
                raise ValueError(f"{name}: {p.shape[dim]} features do not "
                                 f"split over a model axis of {mp}")
            size = p.shape[dim] // mp
            p.data = p.data.narrow(dim, m * size, size).clone()
    return local


def unshard_params(local: torch.nn.Module, mesh,
                   tensor_parallel: bool = True) -> Dict[str, torch.Tensor]:
    """The full parameters (a ``state_dict`` on the host) from each
    process's shards: the TP ones gathered over the model group."""
    mp = int(mesh.shape["model"])
    specs = param_partition_specs(local, tensor_parallel)
    full = {}
    for name, p in local.named_parameters():
        dim = specs[name]
        t = p.detach()
        if dim is not None and mp > 1:
            bufs = [torch.empty_like(t) for _ in range(mp)]
            dist.all_gather(bufs, t.contiguous(), group=mesh.group("model"))
            t = torch.cat(bufs, dim=dim)
        full[name] = t.cpu().clone()
    return full


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The partial products summed over the model group; identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group, forward and backward: every process's loss
    term depends on the summed value, so each one's gradient is the sum
    of all of theirs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Shard:
    """One process's part of the sharded forward (``CNN.forward``'s
    ``shard``): ``rows`` of an ``n_rows`` global batch on a data axis of
    ``dp``, and slice ``m`` of a model axis of ``mp``."""

    def __init__(self, spec, rows, n_rows, dp, mp, m, model_group,
                 data_group):
        self.layers = spec.layers
        self.rows, self.n_rows = rows, n_rows
        self.dp, self.mp, self.m = dp, mp, m
        self.model_group, self.data_group = model_group, data_group

    def _split(self, layer) -> bool:
        return self.mp > 1 and layer.name in _TP_FC_PLAN

    def main(self, model, layer, mod, h, dt):
        if not self._split(layer):
            return model._main(layer, mod, h, dt)
        if layer.name == "fc1":
            if h.dim() > 2:
                h = cnn_mod.to_channels_last(h).reshape(h.shape[0], -1)
            return F.linear(_CopyToModel.apply(h, self.model_group),
                            mod.weight, mod.bias)
        return (_ReduceFromModel.apply(F.linear(h, mod.weight),
                                       self.model_group) + mod.bias)

    def bn_reduce(self, t):
        """The data group's mean of equal shards' statistics (a weight of
        1 / dp, exact for a power of two, and 1 in a world of one, where
        the step stays the plain one bit for bit)."""
        return _AllReduceSum.apply(t * (1.0 / self.dp), self.data_group)

    def dropout_uniform(self, shape, generator, device, i):
        """This process's part of the global batch's channels-last
        uniforms for the layer ``i`` output ``shape``."""
        split = self._split(self.layers[i]) and self.layers[i].name == "fc1"
        width = shape[-1] * (self.mp if split else 1)
        u = cnn_mod._dropout_uniform((self.n_rows, *shape[1:-1], width),
                                     generator, device, i)[self.rows]
        return u[..., self.m * shape[-1]:(self.m + 1) * shape[-1]] \
            if split else u


def make_sharded_train_step(mesh, tensor_parallel: bool = True):
    """DP(+TP) train step over a process mesh: returns ``step(state, x,
    y, key) -> loss``, one optimizer step of ``state`` (a ``TrainState``
    whose model is this process's :func:`shard_params` copy) on this
    process's rows ``x`` (channels last) and one-hots ``y`` (per pixel for
    a dense spec) of the global batch (its data row's slice; every row of
    a data group holds the same rows).  ``key`` keys the dropout
    (``core/rng.key_stream``; None: no dropout).  The loss is the global
    batch's mean CE (``cross_entropy``'s mean over rows and pixels)."""
    set_precision()
    dp, mp = int(mesh.shape["data"]), int(mesh.shape["model"])
    if not tensor_parallel:
        mp = 1

    def step(state, x, y, key=None) -> torch.Tensor:
        model = state.model
        d, m, _ = _cell(mesh)
        b = x.shape[0]
        n = b * dp
        rows = torch.arange(d * b, (d + 1) * b, device=x.device)
        gen = (None if key is None
               else core_rng.key_stream(key, x.device))
        shard = _Shard(model.spec, rows, n, dp, mp, m,
                       mesh.group("model") if mp > 1 else None,
                       mesh.group("data"))
        logits = model(x, train=True, generator=gen, shard=shard).logits
        per = -(y * torch.log_softmax(logits, dim=-1)).sum(-1)
        # the global mean over rows (and a dense spec's pixels)
        loss = per.sum() / (n * per[0].numel())
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        data = mesh.group("data")
        for p in model.parameters():
            if p.grad is not None:
                dist.all_reduce(p.grad, group=data)
        state.optimizer.step()
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=data)
        return loss

    return step


def _local_then_global_topk(scores: torch.Tensor, k: int, mesh, shard: int,
                            device):
    """One shard's top-k, the candidates gathered over the data group and
    the global top-k: ``(values, global indices)``."""
    vals, idx = stable_topk(scores, k)
    all_vals, all_idx = gather_shards(
        mesh, [(vals, idx + shard * scores.shape[0])], device)
    top, pos = stable_topk(all_vals, k)
    return top, all_idx[pos]


def sharded_pool_topk(mesh, score_fn, k: int):
    """``topk(model, patches) -> (top_scores, top_global_idx)`` over a
    process mesh: ``patches`` are this process's data shard (equal shards
    of the pool, in rank order along the data axis) and ``score_fn(model,
    x)`` gives per-patch scores (larger = selected)."""
    def topk(model, patches):
        ((shard, dev),) = local_shards(mesh)
        return _local_then_global_topk(score_fn(model, patches), k, mesh,
                                       shard, dev)

    return topk
