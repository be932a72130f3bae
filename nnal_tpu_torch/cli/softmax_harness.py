"""Softmax-regression AL comparison harness (counterpart of
``nnal_tpu/cli/softmax_harness.py``)::

    python -m nnal_tpu_torch.cli.softmax_harness [--device cuda|cpu]

Rebuild of the reference's MNIST harness (``NNAL.test_MNIST`` +
NNAL_tools.py:116-360): compare FI / random / entropy querying on a linear
softmax model trained by full-batch gradient descent.  MNIST is not
downloadable here, so the harness runs on a synthetic MNIST-like dataset
(Gaussian class clusters) or any ``(X, y)`` the caller passes.  The FI
score is the closed form ``(||x||^2 + 1)(1 - ||p||^2)``.  The model and
the scores live on ``device`` (default: the card; CUDA missing raises);
the selection and the streams are the JAX package's host numpy.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from nnal_tpu_torch.core.device import resolve_device
from nnal_tpu_torch.scoring.cls_strategies import linear_softmax_fi_scores
from nnal_tpu_torch.scoring.uncertainty import shannon_entropy


def synthetic_mnist(n_per_class: int = 200, nclass: int = 10, d: int = 64,
                    seed: int = 0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(nclass, d)) * 2.0
    X = np.concatenate([centers[c] + rng.normal(size=(n_per_class, d))
                        for c in range(nclass)]).astype(np.float32)
    y = np.repeat(np.arange(nclass), n_per_class)
    perm = rng.permutation(len(y))
    return X[perm], y[perm]


def _softmax_train(W, b, X, Y, lr: float, steps: int):
    """``steps`` full-batch gradient steps of the linear softmax model
    (the JAX ``fori_loop``), every operand float32; the divisor is a
    tensor, which the card does not turn into a reciprocal multiply."""
    lr_t = X.new_full((), lr)
    n = X.new_full((), X.shape[0])
    for _ in range(int(steps)):
        p = torch.softmax(X @ W + b, dim=-1)
        g = (p - Y) / n
        W, b = W - (lr_t * X.T) @ g, b - lr_t * g.sum(0)
    return W, b


def run_comparison(X, y, nclass: int, *, k: int = 10, rounds: int = 10,
                   init_size: int = 20, test_ratio: float = 0.3,
                   seed: int = 0, lr: float = 0.5, steps: int = 200,
                   device=None) -> Dict[str, np.ndarray]:
    """Accuracy curves of random, entropy and fi querying (``rounds``
    rounds of ``k`` queries each, retrained from zeros every round)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = len(y)
    perm = rng.permutation(n)
    n_test = int(test_ratio * n)
    test, rest = perm[:n_test], perm[n_test:]
    Y = np.eye(nclass, dtype=np.float32)[y]
    X_d = torch.from_numpy(np.asarray(X, np.float32)).to(dev)
    Y_d = torch.from_numpy(Y).to(dev)
    y_test = np.asarray(y)[test]

    def rows(a, inds):
        return a[torch.from_numpy(np.asarray(inds, np.int64)).to(dev)]

    curves = {}
    for method in ("random", "entropy", "fi"):
        m_rng = np.random.default_rng(seed + 1)
        train = rest[:init_size].copy()
        pool = rest[init_size:].copy()
        accs = []
        for _ in range(rounds):
            W = X_d.new_zeros((X_d.shape[1], nclass))
            b = X_d.new_zeros((nclass,))
            W, b = _softmax_train(W, b, rows(X_d, train), rows(Y_d, train),
                                  lr, steps)
            Xp = rows(X_d, pool)
            posts = torch.softmax(Xp @ W + b, dim=-1)
            if method == "random":
                q = m_rng.permutation(len(pool))[:k]
            elif method == "entropy":
                ent = shannon_entropy(posts).cpu().numpy()
                q = np.argsort(-ent, kind="stable")[:k]
            else:
                fi = linear_softmax_fi_scores(Xp, posts).cpu().numpy()
                q = np.argsort(-fi, kind="stable")[:k]
            train = np.concatenate([train, pool[q]])
            pool = np.delete(pool, q)
            preds = torch.argmax(rows(X_d, test) @ W + b, dim=-1)
            accs.append(float((preds.cpu().numpy() == y_test).mean()))
        curves[method] = np.asarray(accs)
    return curves


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            print(__doc__)
            return 1
        device = argv[i + 1]
    X, y = synthetic_mnist()
    curves = run_comparison(X, y, 10, device=device)
    for m, c in curves.items():
        print(m, " ".join(f"{v:.3f}" for v in c))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
