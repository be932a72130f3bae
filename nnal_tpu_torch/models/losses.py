"""The finetune's losses (counterpart of the losses of
``nnal_tpu/models/train.py``'s scan and of ``nnal_tpu/models/losses.py``).

* :func:`masked_cross_entropy`: class-weighted CE, weighted-mean over rows;
* :func:`fcn_cross_entropy`: the dense (per-pixel) CE over NaN-masked
  one-hot label maps, with class weights or the focal form;
* :func:`aleatoric_ce_per_sample` / :func:`aleatoric_ce`: the AU_4L
  heteroscedastic CE over ``mc_t`` logit-noise samples;
* :func:`lwf_distillation`: the LwF term as the scan computes it;
* :func:`consistency_loss`: the mean teacher's CE or MSE;
* the library losses of ``losses.py`` that no engine path calls
  (:func:`cross_entropy`, :func:`soft_cross_entropy`,
  :func:`generalized_ce`, :func:`focal_loss`, :func:`lwf_loss`, the
  dispatch :func:`get_loss_fn`) and :func:`weight_decay_penalty`, which
  ``models/train.make_train_step`` adds under ``weight_decay``.

The aleatoric normals come from :func:`_aleatoric_normal`, the one place
they are drawn, so a test can feed JAX's draws through it.
"""

from __future__ import annotations

import torch


def weighted_mean(per, w):
    """Mean of per-row losses weighted by ``w``: zero-weight (padding) rows
    add nothing, and an all-zero ``w`` gives 0."""
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


def masked_cross_entropy(logits, y_onehot, class_weights, w):
    """The finetune loss (``train.py:259-264``): class-weighted CE, then the
    mean over rows weighted by ``w``."""
    per = -(y_onehot * torch.log_softmax(logits, dim=-1)).sum(-1)
    per = per * (y_onehot * class_weights).sum(-1)
    return weighted_mean(per, w)


def fcn_cross_entropy(logits, mask_onehot, class_weights=None,
                      focal_gamma=None):
    """Dense CE over per-pixel one-hots (``losses.py:53-74``): pixels whose
    one-hot holds a NaN are unlabeled and drop out; the mean is over the
    labeled pixels (at least 1).  ``logits`` and ``mask_onehot`` are
    ``(b, H, W, c)``; ``focal_gamma`` gives ``-(1 - p)^gamma log p``."""
    valid = ~torch.isnan(mask_onehot.sum(-1))
    y = torch.nan_to_num(mask_onehot)
    logp = torch.log_softmax(logits, dim=-1)
    if focal_gamma is not None:
        per = -(y * (1 - logp.exp()) ** focal_gamma * logp).sum(-1)
    else:
        per = -(y * logp).sum(-1)
    if class_weights is not None:
        per = per * (y * torch.as_tensor(class_weights, dtype=y.dtype,
                                         device=y.device)).sum(-1)
    per = torch.where(valid, per, torch.zeros_like(per))
    return per.sum() / torch.clamp(valid.sum(), min=1)


def _aleatoric_normal(shape, generator: torch.Generator,
                      device) -> torch.Tensor:
    """Standard normals in f32 of shape ``(mc_t, b, c)``: one ``(b, c)``
    draw per noise sample.  JAX draws sample t from the t-th key of
    ``split(fold_in(step_key, 1), mc_t)``; ``generator`` stands for that
    parent key."""
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def aleatoric_ce_per_sample(logits, log_sigma, y_onehot,
                            generator: torch.Generator, mc_t: int = 10):
    """Per-row heteroscedastic CE (``losses.py:77-94``): the mean over
    ``mc_t`` draws of CE at ``logits + sigma * eps``, ``sigma =
    exp(clip(log_sigma, -10, 10))`` (the clamp keeps a diverging sigma
    head from overflowing ``exp``)."""
    sigma = torch.exp(torch.clamp(log_sigma, -10.0, 10.0))
    eps = _aleatoric_normal((mc_t,) + tuple(logits.shape), generator,
                            logits.device)
    logp = torch.log_softmax(logits + sigma * eps, dim=-1)
    return (-(y_onehot * logp).sum(-1)).mean(0)


def aleatoric_ce(logits, log_sigma, y_onehot, generator: torch.Generator,
                 mc_t: int = 10):
    """Mean heteroscedastic CE (``losses.py:97-99``)."""
    return aleatoric_ce_per_sample(logits, log_sigma, y_onehot, generator,
                                   mc_t).mean()


def lwf_distillation(logits, old_logits, w, T: float = 2.0):
    """LwF (reference ``get_LwF``): CE of the softened logits against the
    previous model's softened posterior at temperature ``T``, per row and
    then ``w``-weighted, as the scan adds it (``train.py:265-270``)."""
    # a tensor divisor: the card turns a Python-scalar divisor into a
    # reciprocal multiply, which rounds differently
    t = logits.new_full((), T)
    soft = torch.softmax(old_logits / t, dim=-1)
    lp = torch.log_softmax(logits / t, dim=-1)
    return weighted_mean(-(soft * lp).sum(-1), w)


def consistency_loss(student_logits, teacher_logits, measure: str = "CE"):
    """Mean-teacher consistency (``losses.py:102-114``): CE of the student
    against the teacher's posterior, or the MSE of the posteriors; the
    teacher's side carries no gradient."""
    t_post = torch.softmax(teacher_logits.detach(), dim=-1)
    if measure == "CE":
        logp = torch.log_softmax(student_logits, dim=-1)
        return -(t_post * logp).sum(-1).mean()
    if measure == "MSE":
        s_post = torch.softmax(student_logits, dim=-1)
        return ((s_post - t_post) ** 2).mean()
    raise ValueError(measure)


def _class_weight(y_onehot, class_weights):
    return (y_onehot * torch.as_tensor(class_weights, dtype=y_onehot.dtype,
                                       device=y_onehot.device)).sum(-1)


def cross_entropy(logits, y_onehot, class_weights=None):
    """Mean softmax CE, optionally times each row's class weight
    (``losses.py:18-26``)."""
    per = -(y_onehot * torch.log_softmax(logits, dim=-1)).sum(-1)
    if class_weights is not None:
        per = per * _class_weight(y_onehot, class_weights)
    return per.mean()


def soft_cross_entropy(logits, soft_targets):
    """CE against soft class distributions (``losses.py:29-32``)."""
    return -(soft_targets * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def generalized_ce(logits, y_onehot, q: float = 0.7):
    """The GCE loss ``(1 - p_y^q) / q`` with ``p_y`` clipped at 1e-8
    (``losses.py:35-39``)."""
    py = (y_onehot * torch.softmax(logits, dim=-1)).sum(-1)
    return ((1.0 - torch.clamp(py, min=1e-8) ** q) / q).mean()


def focal_loss(logits, y_onehot, gamma: float = 2.0, class_weights=None):
    """The focal loss ``-(1 - p_y)^gamma log p_y``, optionally times the
    class weight (``losses.py:42-50``)."""
    logp = torch.log_softmax(logits, dim=-1)
    per = -(y_onehot * (1 - logp.exp()) ** gamma * logp).sum(-1)
    if class_weights is not None:
        per = per * _class_weight(y_onehot, class_weights)
    return per.mean()


def lwf_loss(logits, y_onehot, old_logits, lambda_o: float, T: float = 2.0):
    """Learning without forgetting as one loss (``losses.py:117-124``): CE
    plus ``lambda_o`` times the CE of the softened logits against the
    previous model's softened posterior at temperature ``T``."""
    t = logits.new_full((), T)
    soft = torch.softmax(old_logits / t, dim=-1)
    distill = -(soft * torch.log_softmax(logits / t, dim=-1)).sum(-1).mean()
    return cross_entropy(logits, y_onehot) + lambda_o * distill


def weight_decay_penalty(model: torch.nn.Module, coeff: float,
                         compute_dtype=None):
    """``coeff`` times the sum of squares of every weight matrix and kernel
    (the ``<layer>.weight`` parameters: the JAX layout's ``W`` leaves;
    biases and batch norm's gamma and beta are left out), each summed in
    f32 in layer order (``losses.py:127-131``).  ``compute_dtype`` squares
    the weights as rounded to it, as the JAX step does after its
    mixed-precision cast."""
    sq = 0.0
    for name, p in model.named_parameters():
        if name.endswith(".weight"):
            w = p if compute_dtype is None else p.to(compute_dtype)
            sq = sq + (w.float() ** 2).sum()
    return coeff * sq


def get_loss_fn(name: str = "CE", **kw):
    """The loss ``(logits, y) -> scalar`` keyed like the reference's
    ``loss_name`` (``losses.py:134-145``): ``CE`` (``class_weights``),
    ``CE_softclasses``, ``GCE`` (``q``) or ``focal`` (``gamma``,
    ``class_weights``)."""
    if name == "CE":
        return lambda lg, y: cross_entropy(lg, y, kw.get("class_weights"))
    if name == "CE_softclasses":
        return soft_cross_entropy
    if name == "GCE":
        return lambda lg, y: generalized_ce(lg, y, kw.get("q", 0.7))
    if name == "focal":
        return lambda lg, y: focal_loss(lg, y, kw.get("gamma", 2.0),
                                        kw.get("class_weights"))
    raise ValueError(name)
