"""Plain PyTorch PW1, written from the published layer table.

PW1 is the patch-wise segmentation network of Sourati et al. (``create_PW1``
of jsourati/nn-active-learning, ``NN.py:1319-1355``):

    conv24 5x5 . conv32 5x5 . maxpool 2x2 . conv48 3x3 . conv96 3x3 .
    maxpool 2x2 . fc4096 . fc4096 . fc<nclass>

ReLU after every conv and the two hidden fcs, 'same' convolutions, pools
of stride 2 that pad their high side with -inf (ceil: 25 -> 13 -> 7), and
dropout on the outputs of the three fcs (the reference's dropout list
[6, 7, 8]).

Weights are a dict ``name -> tensor`` in PyTorch's layout: a conv's
``(out, in, kh, kw)``, an fc's ``(out, in)``; the first fc reads the last
pool's output flattened in (row, column, channel) order.  Nothing here
imports the program under test.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CONVS = (("conv1", 24, 5), ("conv2", 32, 5), None,
         ("conv3", 48, 3), ("conv4", 96, 3), None)
FCS = ("fc1", "fc2", "fc3")
HIDDEN = 4096


def pooled(n: int) -> int:
    """Output side of a 2x2, stride-2 pool that pads its high side."""
    return -(-n // 2)


def param_shapes(patch: Tuple[int, int], channels: int,
                 nclass: int) -> Dict[str, Tuple[int, ...]]:
    """``name -> shape`` of every weight and bias."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    c = channels
    h, w = patch
    for row in CONVS:
        if row is None:
            h, w = pooled(h), pooled(w)
            continue
        name, out, k = row
        shapes[f"{name}.weight"] = (out, c, k, k)
        shapes[f"{name}.bias"] = (out,)
        c = out
    d = h * w * c
    for name, out in zip(FCS, (HIDDEN, HIDDEN, nclass)):
        shapes[f"{name}.weight"] = (out, d)
        shapes[f"{name}.bias"] = (out,)
        d = out
    return shapes


def _pool(h: torch.Tensor) -> torch.Tensor:
    ph, pw = h.shape[2] % 2, h.shape[3] % 2
    if ph or pw:
        h = F.pad(h, (0, pw, 0, ph), value=float("-inf"))
    return F.max_pool2d(h, 2, 2)


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
            masks: Optional[Sequence[torch.Tensor]] = None,
            keep: float = 0.5) -> torch.Tensor:
    """Logits of ``x`` (n, channels, d1, d2).  ``masks``: one uniform
    tensor per fc output (fc1, fc2, fc3); an output unit is kept where its
    uniform is below ``keep`` and then divided by ``keep``."""
    h = x
    for row in CONVS:
        if row is None:
            h = _pool(h)
            continue
        name, _, k = row
        h = F.relu(F.conv2d(h, params[f"{name}.weight"],
                            params[f"{name}.bias"], padding=(k - 1) // 2))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    for i, name in enumerate(FCS):
        h = F.linear(h, params[f"{name}.weight"], params[f"{name}.bias"])
        if i < 2:
            h = F.relu(h)
        if masks is not None:
            k = h.new_full((), keep)
            h = torch.where(masks[i] < keep, h / k, torch.zeros_like(h))
    return h


def fc_widths(nclass: int) -> List[int]:
    """Widths of the dropout masks, in the order they are drawn."""
    return [HIDDEN, HIDDEN, nclass]


def class_weights(labels, nclass: int):
    """Inverse class frequency over the labeled rows, scaled to sum to
    ``nclass`` (computed in float64, rounded to float32)."""
    counts = np.bincount(np.asarray(labels, np.int64),
                         minlength=nclass).astype(np.float64)
    inv = counts.sum() / np.maximum(counts, 1.0)
    return (inv / inv.sum() * nclass).astype(np.float32)


def weighted_ce(logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                cw: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of one-hot ``y`` per row times its class's weight
    ``cw``, mean weighted by ``w``."""
    per = -(y * torch.log_softmax(logits, dim=-1)).sum(-1)
    per = per * (y * cw).sum(-1)
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


class Adam:
    """Adam (Kingma and Ba) with bias correction: ``b1`` 0.9, ``b2`` 0.999,
    ``eps`` 1e-8 added to the corrected root."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        with torch.no_grad():
            for k, g in grads.items():
                self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                denom = self.v[k].sqrt() / (bc2 ** 0.5) + self.eps
                params[k].addcdiv_(self.m[k], denom, value=-self.lr / bc1)


Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
              Sequence[torch.Tensor]]


def train_steps(params: Dict[str, torch.Tensor], opt: Adam,
                cw: torch.Tensor, batches: Sequence[Batch]
                ) -> Optional[Dict[str, torch.Tensor]]:
    """One Adam step per ``(x, y, w, masks)`` batch on ``params`` in place,
    the rows' losses weighted by their class's ``cw``.  Returns the first
    step's gradients (None without a batch)."""
    first = None
    for x, y, w, masks in batches:
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = weighted_ce(forward(leaves, x, masks), y, w, cw)
        g = torch.autograd.grad(loss, list(leaves.values()))
        step_grads = dict(zip(leaves, g))
        opt.step(params, step_grads)
        if first is None:
            first = step_grads
    return first
