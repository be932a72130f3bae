"""Fisher-information query-distribution solver (counterpart of
``nnal_tpu/scoring/sdp.py:36-250``).

The reference's SDP (NNAL_tools.py:576-720) is, by Schur complement,
A-optimal experiment design over the simplex,

    min_q  tr( I(q)^{-1} ),   I(q) = sum_i q_i A_i,

with an optional peak cap ``q_i <= 1/k`` and, for ``lambda_ > 0``, a
representativeness term ``-lambda * ||x_i||^2 q_i`` whose zero-mean
feature equality ``F q = 0`` becomes a quadratic penalty.  L (the number of
layers after 'sum' shrinkage, 7 for PW1) is tiny and n = B a few hundred,
so the solver runs on the A-matrices' device in float32, as the JAX
package's jitted loop does: the multiplicative A-optimal rule for the pure
objective, Frank-Wolfe-gap-certified projected gradient with Armijo
backtracking for the composite one.

Eager PyTorch has no ``while_loop``, and a host read of the gap per
iteration would stall on every one, so the loop runs in blocks of
``block`` iterations with no host synchronization inside (``cholesky_ex``
and ``inv_ex`` do not check for errors; sorts are stable, as JAX's are)
and reads the gap once per block.  This is exact: the JAX body freezes q
once its gap is within ``tol``, so iterations after convergence change
nothing, and the last block is cut to end at exactly ``steps``.  On the
card each full block after the first is captured once as a CUDA graph and
replayed: an iteration launches dozens of tiny kernels, and replaying
them costs the host nothing.  The capped normalization and projection
find their roots from every breakpoint at once (see
:func:`_normalize_capped`) where the JAX package bisects 80 times: the
same roots, without 640 sequential launches per iteration.  The Armijo
search evaluates its 41 step sizes ``2 gamma 0.5^i`` as one batch and
takes ``i* = min(first i meeting Armijo, 40)``, which is what the JAX
``while_loop`` (at most 40 halvings) picks.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from nnal_tpu_torch.core.device import resolve_device

_LS_STEPS = 40          # the JAX Armijo loop halves at most 40 times


class Solution(NamedTuple):
    q: torch.Tensor            # (n,) the optimal query PMF
    rel_gap: torch.Tensor      # FW duality gap / |f(q)| at q
    iters: int                 # loop iterations the JAX while_loop runs


def _trinv(M: torch.Tensor) -> torch.Tensor:
    """tr(M^{-1}) via Cholesky (M is PSD by diagonal loading); batched
    over leading dimensions."""
    L, _ = torch.linalg.cholesky_ex(M)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return (Linv ** 2).sum((-2, -1))


def _grad_trinv(A: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """d/dq_i tr(M(q)^{-1}) = -tr(M^{-1} A_i M^{-1})."""
    M = torch.einsum("n,nab->ab", q, A)
    Minv, _ = torch.linalg.inv_ex(M)
    G = Minv @ Minv
    return -torch.einsum("ab,nab->n", G, A)


def _lmo_capped_simplex(grad: torch.Tensor, cap: float) -> torch.Tensor:
    """Linear minimization oracle over {q: sum q = 1, 0 <= q <= cap}: fill
    the lowest-gradient coordinates up to ``cap`` each (stable ranks)."""
    order = torch.argsort(grad, stable=True)
    ranks = torch.empty_like(order).scatter_(
        0, order, torch.arange(grad.shape[0], device=grad.device))
    # the JAX package's float32 arithmetic for the fill count and remainder
    full = int(np.floor(np.float32(1.0 / cap)))
    frac = float(np.float32(1.0) - np.float32(full) * np.float32(cap))
    return torch.where(ranks < full, cap,
                       torch.where(ranks == full, frac, 0.0)).to(grad.dtype)


def _normalize_capped(u: torch.Tensor, cap: float) -> torch.Tensor:
    """Exact 'normalize with caps': ``min(cap, theta * u)`` with theta such
    that ``s(theta) = sum(min(cap, theta * u)) == 1``.

    s is piecewise linear and nondecreasing, with breakpoints ``cap /
    u_i``.  The JAX package bisects 80 times inside ``[0, 1e12 / max
    u]``; here s is evaluated at every breakpoint of that bracket at once,
    the bracket is narrowed to the last breakpoint with ``s < 1`` and the
    first with ``s >= 1`` (the bisection's own ``lo``/``hi`` rule), and
    the root is the linear interpolation between them — the value the
    bisection converges to, in a handful of kernels instead of 640."""
    hi0 = 1e12 / torch.clamp(u.max(), min=1e-30)
    b = torch.where(u > 0, cap / u, hi0)
    b = torch.cat([torch.clamp(b, max=hi0), hi0.new_zeros(1), hi0[None]])
    s = torch.clamp(b[:, None] * u, max=cap).sum(1)
    below = s < 1.0
    lo = torch.where(below, b, 0.0).amax()
    s_lo = torch.where(below, s, 0.0).amax()
    hi = torch.where(below, hi0, b).amin()
    s_hi = torch.where(below, float("inf"), s).amin()
    # no breakpoint reaches 1 (caps too tight): the bisection ends at hi0
    theta = torch.where(torch.isfinite(s_hi),
                        lo + (1.0 - s_lo) * (hi - lo) / (s_hi - s_lo), lo)
    return torch.clamp(theta * u, max=cap)


def _project_capped(u: torch.Tensor, cap: float) -> torch.Tensor:
    """Euclidean projection of each row of ``u`` (..., n) onto {q: sum q =
    1, 0 <= q <= cap}: ``clip(u - tau, 0, cap)`` with tau the root of
    ``s(tau) = sum(clip(u - tau, 0, cap)) == 1``.  s is piecewise linear
    and nonincreasing with breakpoints ``u_i`` and ``u_i - cap``; as in
    :func:`_normalize_capped`, s is evaluated at every breakpoint inside
    the JAX bisection's bracket ``[min u - 1/n, max u]`` and tau
    interpolated between the last with ``s > 1`` and the first with
    ``s <= 1``."""
    lo0 = u.amin(-1, keepdim=True) - 1.0 / u.shape[-1]
    hi0 = u.amax(-1, keepdim=True)
    b = torch.cat([u, u - cap, lo0, hi0], -1)
    b = torch.minimum(torch.maximum(b, lo0), hi0)
    s = torch.clamp(u[..., None, :] - b[..., :, None], 0.0, cap).sum(-1)
    above = s > 1.0
    lo = torch.where(above, b, lo0).amax(-1, keepdim=True)
    s_lo = torch.where(above, s, float("inf")).amin(-1, keepdim=True)
    hi = torch.where(above, hi0, b).amin(-1, keepdim=True)
    s_hi = torch.where(above, float("-inf"), s).amax(-1, keepdim=True)
    # s(lo0) <= 1 already (caps too tight): the bisection ends at lo0
    tau = torch.where(torch.isfinite(s_lo),
                      lo + (s_lo - 1.0) * (hi - lo) / (s_lo - s_hi), hi)
    return torch.clamp(u - tau, 0.0, cap)


def _armijo(objective, q, g, f0, gamma, cap: float):
    """One projected-gradient step with Armijo backtracking, all step sizes
    at once: candidates ``2 gamma 0.5^i`` (i = 0..40) are projected and
    scored as one batch, and the step taken is ``i* = min(first i whose
    candidate meets Armijo, 40)`` — what the JAX ``while_loop`` picks (it
    halves while the test fails, at most 40 times).  Returns ``(q_new,
    step)``."""
    steps_i = gamma * 2.0 * 0.5 ** torch.arange(
        _LS_STEPS + 1, dtype=q.dtype, device=q.device)
    cand = _project_capped(q - steps_i[:, None] * g, cap)
    fails = objective(cand) > f0 + 0.3 * ((cand - q) @ g)
    # leading failures = the first i meeting Armijo (40 if none does);
    # index_select keeps i* on the device (a 0-d index would be read back)
    i_star = torch.cumprod(fails[:_LS_STEPS].to(torch.int64), 0).sum()
    i_star = i_star.reshape(1)
    return cand.index_select(0, i_star)[0], steps_i.index_select(0, i_star)[0]


def _run_blocks(body, state, steps: int, block: int, tol: float,
                use_graph: bool) -> None:
    """Run ``body`` (which updates ``state`` in place) until the gap it
    leaves in ``state["rgap"]`` is within ``tol`` or ``steps`` iterations
    have run; one host read per block.  With ``use_graph`` the first
    block runs eagerly on a side stream (the warm-up a capture needs:
    every library handle and workspace exists before it) and later full
    blocks replay a CUDA graph of one block (capturing runs nothing)."""
    t, graph = 0, None
    while t < steps:
        nb = min(block, steps - t)
        if graph is not None and nb == block:
            graph.replay()
        elif use_graph and t == 0:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(nb):
                    body()
            torch.cuda.current_stream().wait_stream(side)
        else:
            for _ in range(nb):
                body()
        t += nb
        if float(state["rgap"]) <= tol:
            return
        if use_graph and graph is None and steps - t >= block:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(block):
                    body()


def solve_a_optimal(A: torch.Tensor, cap: float = 1.0,
                    lin: Optional[torch.Tensor] = None,
                    F: Optional[torch.Tensor] = None, rho: float = 0.0,
                    steps: int = 2000, tol: float = 1e-5,
                    block: int = 20, graph: Optional[bool] = None
                    ) -> Solution:
    """min_q tr(M(q)^{-1}) + lin.q + rho/2 ||F q||^2 over the capped
    simplex, on ``A``'s device.  ``A``: (n, d, d) stack of per-sample
    conditional Fisher matrices (diagonally loaded upstream).

    Pure A-optimal (``lin``/``F`` absent): the multiplicative design rule
    ``q <- normalize_capped(q * sqrt(w))``, ``w_i = tr(M^-1 A_i M^-1)``.
    Composite: projected gradient with Armijo backtracking (the step warm-
    starts at twice the last accepted one).  Both stop once the FW duality
    gap over the capped simplex is within ``tol * |f(q)|``.  ``graph``
    (default: on CUDA) replays blocks as a CUDA graph; ``False`` keeps the
    loop eager, which ``chip_smoke.py`` times beside it."""
    n = A.shape[0]
    dev, dt = A.device, A.dtype
    lin_t = torch.zeros(n, dtype=dt, device=dev) if lin is None else lin
    FtF = None if (F is None or rho == 0.0) else (F.T @ F) * rho
    composite = lin is not None or FtF is not None

    def objective(Q):                      # (K, n) -> (K,)
        M = torch.einsum("kn,nab->kab", Q, A)
        f = _trinv(M) + Q @ lin_t
        if FtF is not None:
            f = f + 0.5 * ((Q @ FtF) * Q).sum(-1)
        return f

    def gradient(q):
        g = _grad_trinv(A, q) + lin_t
        if FtF is not None:
            g = g + FtF @ q
        return g

    def gap_and_f(q, g):
        s = _lmo_capped_simplex(g, cap)
        f = objective(q[None])[0]
        return torch.dot(g, q - s) / torch.clamp(f.abs(), min=1e-12), f

    st = {"q": torch.full((n,), 1.0 / n, dtype=dt, device=dev),
          "rgap": torch.full((), float("inf"), dtype=dt, device=dev),
          "gamma": torch.ones((), dtype=dt, device=dev),
          "updates": torch.zeros((), dtype=torch.int64, device=dev)}

    def body_mult():
        q = st["q"]
        g = gradient(q)
        rgap, _ = gap_and_f(q, g)
        w = torch.clamp(-g, min=1e-30)     # w_i = tr(M^-1 A_i M^-1)
        active = rgap > tol
        st["q"].copy_(torch.where(active, _normalize_capped(
            q * torch.sqrt(w), cap), q))
        st["rgap"].copy_(rgap)
        st["updates"].add_(active)

    def body_fw():
        q = st["q"]
        g = gradient(q)
        rgap, f0 = gap_and_f(q, g)
        q_new, gamma = _armijo(objective, q, g, f0, st["gamma"], cap)
        active = rgap > tol
        st["q"].copy_(torch.where(active, q_new, q))
        st["gamma"].copy_(gamma)
        st["rgap"].copy_(rgap)
        st["updates"].add_(active)

    _run_blocks(body_fw if composite else body_mult, st, steps, block, tol,
                use_graph=dev.type == "cuda" if graph is None else graph)
    q = st["q"]
    # the loop's gap is one iterate stale; report the final one
    rgap, _ = gap_and_f(q, gradient(q))
    return Solution(q, rgap, min(int(st["updates"]) + 1, steps))


def fi_query_distribution(A, lambda_: float = 0.0, X_pool=None, k=None,
                          cap_peak: bool = False, steps: int = 2000,
                          rho: float = 10.0, tol: float = 1e-4,
                          device=None) -> np.ndarray:
    """The reference ``SDP_query_distribution`` (NNAL_tools.py:613):
    returns the optimal query PMF as a float64 numpy vector.

    ``A``: a (n, d, d) tensor or a list/stack of (d, d) conditional-FI
    matrices.  The solve runs in float32 on ``device``; ``None`` means
    ``A``'s own device when ``A`` is a tensor, else the card.
    ``lambda_ > 0`` activates the representativeness objective with
    zero-mean features ``X_pool`` (d_feat, n); ``cap_peak`` applies the
    cap ``q_i <= 1/k``."""
    if device is None and isinstance(A, torch.Tensor):
        dev = A.device
    else:
        dev = resolve_device(device)
    if not isinstance(A, torch.Tensor):
        A = torch.as_tensor(np.stack([np.asarray(a) for a in A]))
    A = A.to(device=dev, dtype=torch.float32)
    n = A.shape[0]
    cap = (1.0 / k) if (cap_peak and k) else 1.0
    lin = F = None
    use_rho = 0.0
    if lambda_ > 0 and X_pool is not None and np.size(X_pool) > 0:
        F = torch.as_tensor(np.asarray(X_pool), dtype=torch.float32,
                            device=dev)
        lin = -lambda_ * (F ** 2).sum(0)
        use_rho = rho
    sol = solve_a_optimal(A, cap=cap, lin=lin, F=F, rho=use_rho,
                          steps=steps, tol=tol)
    rel_gap = float(sol.rel_gap)
    if rel_gap > 100 * tol:
        warnings.warn(f"A-optimal solver stopped at relative duality gap "
                      f"{rel_gap:.2e} after {steps} steps (tol={tol})")
    q = sol.q.cpu().numpy().astype(np.float64)
    q[q < 0] = 0.0
    s = q.sum()
    return q / s if s > 0 else np.full(n, 1.0 / n)


def trace_inverse(q, A) -> float:
    """Objective value tr(M(q)^{-1}) — exposed for tests."""
    M = np.einsum("n,nab->ab", np.asarray(q), np.asarray(A))
    return float(np.trace(np.linalg.inv(M)))
