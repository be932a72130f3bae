"""Sharded training and pool top-k over ``torch.distributed`` process
groups (counterpart of ``nnal_tpu/parallel/sharding.py``).

One process per cell of a process mesh (``multihost.make_multihost_mesh``):

* **DP**: each data row holds its slice of the global batch; after the
  backward every gradient is summed over the data group (an
  ``all_reduce``), the loss being the global batch mean, so each process
  takes the step GSPMD derives from JAX's ``P("data")`` batch.
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

Dropout draws the GLOBAL batch's uniforms through
``models/cnn._dropout_uniform`` (the seam the tests feed JAX's draws
through) and each process keeps its rows, and ``fc1``'s its columns, so
the masks are the single-process step's.  The step takes sequential
specs (PW1, the VGG / AlexNet shapes): skip sources and batch norm raise.
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from nnal_tpu_torch.core import rng as core_rng
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


def _check_sequential(spec) -> None:
    for layer in spec.layers:
        if layer.sources or "B" in layer.op_order:
            raise NotImplementedError(
                "the sharded train step takes sequential specs without "
                f"batch norm; layer {layer.name!r} has "
                + ("skip sources" if layer.sources else "batch norm"))


def _sharded_forward(model, x, generator, rows, n_rows, mp, m, group):
    """``CNN.forward(x, train=True)`` over this process's ``rows`` of an
    ``n_rows`` global batch and its model-axis slice ``m`` of ``mp``:
    the logits."""
    h = x.permute(0, 3, 1, 2)
    dt = h.dtype
    for i, layer in enumerate(model.spec.layers):
        mod = getattr(model, layer.name, None)
        split = mp > 1 and layer.name in _TP_FC_PLAN
        for op in ("M" if layer.kind in ("pool", "avgpool")
                   else layer.op_order):
            if op == "A":
                h = model.act(h)
            elif not split:
                h = model._main(layer, mod, h, dt)
            elif layer.name == "fc1":
                if h.dim() > 2:
                    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
                h = F.linear(_CopyToModel.apply(h, group), mod.weight,
                             mod.bias)
            else:
                h = (_ReduceFromModel.apply(F.linear(h, mod.weight), group)
                     + mod.bias)
        if layer.dropout > 0 and generator is not None:
            keep = 1.0 - layer.dropout
            if h.dim() == 4:
                b, c, hh, ww = h.shape
                u = cnn_mod._dropout_uniform(
                    (n_rows, hh, ww, c), generator, h.device, i
                )[rows].permute(0, 3, 1, 2)
            else:
                width = h.shape[1] * (mp if split and layer.name == "fc1"
                                      else 1)
                u = cnn_mod._dropout_uniform((n_rows, width), generator,
                                             h.device, i)[rows]
                if split and layer.name == "fc1":
                    u = u[:, m * h.shape[1]:(m + 1) * h.shape[1]]
            h = torch.where(u < keep, h / h.new_full((), keep),
                            torch.zeros_like(h))
    if h.dim() == 4:
        h = h.permute(0, 2, 3, 1)
    return h if h.dtype == torch.float64 else h.float()


def make_sharded_train_step(mesh, tensor_parallel: bool = True):
    """DP(+TP) train step over a process mesh: returns ``step(state, x,
    y, key) -> loss``, one optimizer step of ``state`` (a ``TrainState``
    whose model is this process's :func:`shard_params` copy) on this
    process's rows ``x`` (channels last) and one-hots ``y`` of the global
    batch (its data row's slice; every row of a data group holds the same
    rows).  ``key`` keys the dropout (``core/rng.key_stream``; None: no
    dropout).  The loss is the global batch's mean CE."""
    dp, mp = int(mesh.shape["data"]), int(mesh.shape["model"])
    if not tensor_parallel:
        mp = 1

    def step(state, x, y, key=None) -> torch.Tensor:
        model = state.model
        _check_sequential(model.spec)
        d, m, _ = _cell(mesh)
        b = x.shape[0]
        n = b * dp
        rows = torch.arange(d * b, (d + 1) * b, device=x.device)
        gen = (None if key is None
               else core_rng.key_stream(key, x.device))
        logits = _sharded_forward(model, x, gen, rows, n, mp, m,
                                  mesh.group("model") if mp > 1 else None)
        per = -(y * torch.log_softmax(logits, dim=-1)).sum(-1)
        loss = per.sum() / n
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
