"""Optimizers, ramps, gradient masks and the EMA teacher (counterpart of
``nnal_tpu/models/optim.py``).

``make_optimizer`` builds ``torch.optim`` SGD/Adam with optax's
hyperparameters (``optax.sgd(lr)``: no momentum; ``optax.adam(lr)``:
b1 0.9, b2 0.999, eps 1e-8) and :class:`RMSProp`, optax's
``rmsprop(lr, decay=0.9, eps=1e-10, momentum=0.0)`` written out, since
``torch.optim.RMSprop`` divides by ``sqrt(v) + eps`` where optax scales by
``rsqrt(nu + eps)``.  ``opt_state_leaves``/``load_opt_state``
convert the optimizer state to and from optax's leaf order, which is what
checkpoints store (see ``models/checkpoint.py``): ``[]`` for SGD,
``[count, *mu, *nu]`` for Adam and ``[*nu, *trace]`` for RMSProp (optax's
state is ``(ScaleByRmsState(nu), EmptyState(), TraceState(trace))``:
``momentum=0.0`` is not ``None``, so the trace is kept).

``sigmoid_rampup`` / ``sigmoid_rampdown`` evaluate in float32 on the host,
as JAX traces them.  ``layer_train_mask`` / ``apply_grad_mask`` freeze
layers by zeroing their gradients: the optimizer still steps every
parameter, as optax does on a masked gradient (a frozen leaf's Adam
moments decay, and it moves while they are nonzero).  ``ema_update`` is
the mean teacher's update, one ``torch._foreach_*`` pass.
``exponential_decay`` and ``constant`` are the learning-rate schedules of
``optim.py:24-48`` (host floats of a host step); ``pft_mask_from_saliency``
/ ``pft_mask_from_threshold`` build partial-finetuning masks from a
diagonal Fisher (``scoring/gradients.diagonal_fisher``'s dict, keyed as
``named_parameters``), which ``apply_grad_mask`` multiplies into the
gradients elementwise.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from nnal_tpu_torch.models.bridge import (
    from_jax_params,
    to_jax_params,
    to_jax_tensors,
)


class RMSProp(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay, eps, momentum=0.0)`` (``optim.py:54-66``),
    each step in optax's f32 operations: ``nu = (1 - decay) * g**2 + decay
    * nu`` (``nu`` starts at 0, no bias correction), ``u = rsqrt(nu + eps)
    * g * -lr``, ``trace = u + 0 * trace`` (the momentum-0 trace, which
    optax keeps in its state) and ``p += trace``.  ``1 - decay`` and the
    other constants are rounded to f32 first, as JAX's weak types do."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-10):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            keep = float(np.float32(group["decay"]))
            move = float(np.float32(1.0 - group["decay"]))
            eps = float(np.float32(group["eps"]))
            neg_lr = float(np.float32(-group["lr"]))
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                    st["trace"] = torch.zeros_like(p)
                g = p.grad
                # in place, each op the f32 rounding of optax's: the sum
                # (1 - decay) * g**2 + decay * nu commutes
                nu = st["nu"].mul_(keep).add_((g * g).mul_(move))
                u = torch.rsqrt(nu + eps).mul_(g).mul_(neg_lr)
                st["trace"].mul_(0.0).add_(u)
                p.add_(st["trace"])


def make_optimizer(name: str, learning_rate: float, params
                   ) -> torch.optim.Optimizer:
    lr = float(learning_rate)
    if name == "SGD":
        return torch.optim.SGD(params, lr=lr)
    if name == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "RMSProp":
        return RMSProp(params, lr=lr, decay=0.9, eps=1e-10)
    raise ValueError(name)


def _ordered(tree):
    """Leaves of a JAX-layout params tree in jax's sorted-key order."""
    return [tree[layer][k] for layer in sorted(tree)
            for k in sorted(tree[layer])]


def opt_state_tensors(optimizer: torch.optim.Optimizer,
                      model: torch.nn.Module) -> list:
    """Optimizer state as optax's leaves: ``[]`` for SGD; for Adam
    ``[count, *mu, *nu]`` with the moments as JAX-layout copies on the
    parameters' device (``bridge.to_jax_tensors``) and ``count`` an int32
    numpy scalar; for :class:`RMSProp` ``[*nu, *trace]``."""
    if isinstance(optimizer, torch.optim.SGD):
        return []
    named = dict(model.named_parameters())
    st = {name: optimizer.state.get(p, {}) for name, p in named.items()}
    moments = []
    for key in _moment_keys(optimizer):
        sd = {name: s[key] if key in s else torch.zeros_like(named[name])
              for name, s in st.items()}
        moments += _ordered(to_jax_tensors(sd))
    if isinstance(optimizer, RMSProp):
        return moments
    count = max((int(s["step"]) for s in st.values() if "step" in s),
                default=0)
    return [np.asarray(count, np.int32)] + moments


def _moment_keys(optimizer):
    """The per-parameter state slots in optax's leaf order."""
    if isinstance(optimizer, RMSProp):
        return ("nu", "trace")
    return ("exp_avg", "exp_avg_sq")


def opt_state_leaves(optimizer: torch.optim.Optimizer,
                     model: torch.nn.Module) -> List[np.ndarray]:
    """:func:`opt_state_tensors` pulled to host numpy arrays."""
    return [v if isinstance(v, np.ndarray) else v.cpu().numpy()
            for v in opt_state_tensors(optimizer, model)]


def load_opt_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                   leaves: List[np.ndarray]) -> None:
    """Install optax-ordered leaves (from a checkpoint) into ``optimizer``;
    no leaves leaves the optimizer fresh, as the JAX loader does."""
    if not leaves:
        return
    if isinstance(optimizer, torch.optim.SGD):
        raise ValueError(f"SGD carries no state; checkpoint has "
                         f"{len(leaves)} optimizer leaves")
    named = dict(model.named_parameters())
    template = to_jax_params({k: v for k, v in named.items()})
    slots = [(layer, k) for layer in sorted(template)
             for k in sorted(template[layer])]
    rms = isinstance(optimizer, RMSProp)
    head = 0 if rms else 1          # Adam's count leads
    if len(leaves) != head + 2 * len(slots):
        raise ValueError(f"checkpoint has {len(leaves)} opt leaves, "
                         f"{type(optimizer).__name__} needs "
                         f"{head + 2 * len(slots)}")
    moments = []
    for part in (leaves[head:head + len(slots)], leaves[head + len(slots):]):
        tree: dict = {}
        for (layer, k), v in zip(slots, part):
            tree.setdefault(layer, {})[k] = v
        moments.append(from_jax_params(tree))
    keys = _moment_keys(optimizer)
    for name, p in named.items():
        st = {key: m[name].to(p.device) for key, m in zip(keys, moments)}
        if not rms:
            st["step"] = torch.tensor(float(int(leaves[0])))
        optimizer.state[p] = st


def sigmoid_rampup(length: int):
    """``t -> exp(-5 (1 - t/length)^2)``, clipped to 1 from ``length`` on
    (``optim.py:31-37``), in float32."""
    def sched(t):
        t = np.asarray(t, np.float32)
        phase = np.clip(np.float32(1.0) - t / np.float32(length),
                        np.float32(0.0), np.float32(1.0))
        return np.exp(np.float32(-5.0) * (phase * phase))
    return sched


def sigmoid_rampdown(length: int, total: int):
    """``t -> exp(-12.5 phase^2)`` over the last ``length`` of ``total``
    steps (``optim.py:40-45``), in float32."""
    def sched(t):
        t = np.asarray(t, np.float32)
        phase = np.clip((t - np.float32(total - length))
                        / np.float32(length), np.float32(0.0),
                        np.float32(1.0))
        return np.exp(np.float32(-12.5) * (phase * phase))
    return sched


def exponential_decay(lr0: float, decay_rate: float,
                      decay_steps: int = 1000):
    """``t -> lr0 * decay_rate ** (t / decay_steps)`` (``optim.py:24-28``)."""
    def sched(t):
        return lr0 * (decay_rate ** (t / decay_steps))
    return sched


def constant(lr: float):
    """``t -> lr`` (``optim.py:47-48``)."""
    return lambda t: lr


def pft_mask_from_saliency(diag_fisher: Dict[str, torch.Tensor], k: int
                           ) -> Dict[str, torch.Tensor]:
    """Partial-finetuning mask: f32 1.0 on the ``k`` globally largest
    diagonal-Fisher entries (ties at the k-th value included) and 0.0
    elsewhere, each mask on its entry's device (reference
    ``keep_k_largest_from_LoV``; ``optim.py:80-96``).  ``k <= 0`` freezes
    everything, ``k`` at least the entry count trains everything."""
    flat = torch.cat([t.detach().reshape(-1).float()
                      for t in diag_fisher.values()])
    if k <= 0:
        thr = float("inf")
    elif k >= flat.numel():
        thr = float("-inf")
    else:
        thr = torch.kthvalue(flat, flat.numel() - k + 1).values.item()
    return pft_mask_from_threshold(diag_fisher, thr)


def pft_mask_from_threshold(diag_fisher: Dict[str, torch.Tensor],
                            thr: float) -> Dict[str, torch.Tensor]:
    """f32 1.0 where the diagonal Fisher is at least ``thr``, else 0.0
    (reference ``threshold_LoV``; ``optim.py:99-103``)."""
    return {name: (t >= thr).float() for name, t in diag_fisher.items()}


def layer_train_mask(model: torch.nn.Module,
                     train_layers: Sequence[str]) -> Dict[str, float]:
    """1.0 for each parameter of a layer in ``train_layers`` and 0.0 for
    the rest (``optim.py:69-77``; an empty list trains everything), keyed
    by the parameter's name (``<layer>.weight``)."""
    keep_all = len(train_layers) == 0
    return {name: 1.0 if keep_all or name.rpartition(".")[0] in train_layers
            else 0.0 for name, _ in model.named_parameters()}


@torch.no_grad()
def apply_grad_mask(model: torch.nn.Module, mask: Optional[Dict]) -> None:
    """Multiply each gradient by its mask entry, in place
    (``optim.py:106-109``): a float per parameter (``layer_train_mask``) or
    a tensor of the parameter's shape (the PFT masks).  A frozen layer's
    gradient becomes zeros (signed, as JAX's ``g * 0``), never ``None``, so
    ``torch.optim.Adam`` keeps stepping it and its per-parameter step count
    stays optax's."""
    if mask is None:
        return
    frozen = []
    for name, p in model.named_parameters():
        m = mask[name]
        if p.grad is None:
            continue
        if isinstance(m, torch.Tensor):
            p.grad.mul_(m.to(p.grad.device))
        elif m == 0.0:
            frozen.append(p.grad)
    if frozen:
        torch._foreach_mul_(frozen, 0.0)


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module,
               decay: float) -> None:
    """``t <- decay * t + (1 - decay) * s`` over every parameter, in place
    (``optim.py:116-122``): one ``_foreach_mul_`` and one
    ``_foreach_add_``.  ``1 - decay`` is taken in float32, as JAX computes
    it from the traced ``decay``."""
    t = list(teacher.parameters())
    s = list(student.parameters())
    d = np.float32(decay)
    torch._foreach_mul_(t, float(d))
    torch._foreach_add_(t, s, alpha=float(np.float32(1.0) - d))
