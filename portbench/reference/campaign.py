"""A plain patch-wise AL campaign with PW1: entropy picks from the pool,
a finetune of the labeled rows with Adam, the test grid's logits.

:class:`Campaign` holds the weights, Adam's state, the labeled rows in
the order they were taken and the pool in its order.  A round is
``pool_p1`` (the pool's posteriors), the picks (the reference's own,
:func:`select`, or another's, handed in as data), ``take`` and
``finetune``.  The finetune's batches and dropout uniforms are worked out
from the seed and the optimizer step the round starts at
(:mod:`reference.draws`), so two campaigns that take the same picks draw
the same.  Nothing here imports the program under test.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from . import draws, pw1


def select(p1: torch.Tensor, k: int) -> np.ndarray:
    """Positions of the ``k`` smallest ``|p1 - 0.5|``, ties in pool
    order."""
    return torch.sort((p1 - 0.5).abs(), stable=True).indices[:k] \
        .cpu().numpy()


class Campaign:
    """One campaign from ``params`` (not modified) on the subject's
    patches ``P`` and voxel ``labels``; ``train`` are the initial labeled
    voxels, ``pool`` the rest of the pool in order."""

    def __init__(self, params: Dict[str, torch.Tensor], P, labels,
                 train: Sequence[int], pool: Sequence[int], seed: int,
                 lr: float, b: int, epochs: int, nclass: int, block: int):
        self.theta = {k: v.clone() for k, v in params.items()}
        self.opt = pw1.Adam(self.theta, lr)
        self.P, self.labels = P, labels
        self.train = np.asarray(train, np.int64)
        self.pool = np.asarray(pool, np.int64)
        self.seed, self.b, self.epochs = int(seed), int(b), int(epochs)
        self.nclass, self.block = int(nclass), int(block)
        self.step0 = 0

    def logits(self, inds, theta=None) -> torch.Tensor:
        theta = self.theta if theta is None else theta
        out = []
        with torch.no_grad():
            for lo in range(0, len(inds), self.block):
                out.append(pw1.forward(theta,
                                       self.P(inds[lo:lo + self.block])))
        return torch.cat(out)

    def pool_p1(self) -> torch.Tensor:
        return torch.softmax(self.logits(self.pool), -1)[:, 1]

    def take(self, picks) -> None:
        """Move the voxels ``picks`` from the pool to the labeled rows."""
        picks = np.asarray(picks, np.int64)
        self.train = np.concatenate([self.train, picks])
        self.pool = self.pool[~np.isin(self.pool, picks)]

    def finetune(self, run: bool = True,
                 batches: Optional[Callable] = None):
        """One finetune of the labeled rows from the current step; returns
        the first step's gradients (None when ``run`` is False, which
        advances the step and leaves the state as it is).  ``batches``
        may rewrite each step's ``(rows, weights)``."""
        dev = self.P.device
        n = len(self.train)
        step0 = self.step0
        self.step0 += draws.step_count(n, self.b, self.epochs)
        if not run:
            return None
        x_all = self.P(self.train)
        y_all = torch.nn.functional.one_hot(torch.as_tensor(
            self.labels[self.train].astype(np.int64), device=dev),
            self.nclass).float()
        cw = torch.as_tensor(pw1.class_weights(self.labels[self.train],
                                               self.nclass), device=dev)
        steps = []
        for i, (rows, w) in enumerate(draws.batches(self.seed, step0, n,
                                                    self.b, self.epochs)):
            if batches is not None:
                rows, w = batches(rows, w)
            r = torch.as_tensor(rows, device=dev)
            steps.append((x_all[r], y_all[r], torch.as_tensor(w, device=dev),
                          draws.dropout_uniforms(self.seed, step0, i,
                                                 len(rows),
                                                 pw1.fc_widths(self.nclass),
                                                 dev)))
        return pw1.train_steps(self.theta, self.opt, cw, steps)
