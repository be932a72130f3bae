"""Dense-CRF posterior refinement (counterpart of
``nnal_tpu/evaluation/crf.py``).

The reference refines 2-D posterior maps with pydensecrf's mean-field
solver (``DCRF_postprocess_2D``, PW_analyze_results.py:539-592): unary
``-log p``, Gaussian smoothness and bilateral appearance pairwise terms,
Potts compatibility, 5 iterations.  Backends:

- ``native``: the permutohedral-lattice solver of ``runtime/dense_crf.cc``
  (``runtime/crf_native``), the full dense pairwise model; it also runs
  the volumetric :func:`dcrf_postprocess_3d`;
- ``pydensecrf``: the external package, when it imports;
- ``torch``: :func:`meanfield_crf_2d`, a truncated-window mean field in
  plain torch on the tensor's device (the JAX package's on-device CRF,
  ``crf.py:37-92``: 120 rolled neighbour messages an iteration).

``backend="auto"`` tries them in that order and warns when it falls back
(once per message, the warnings filter's default; the JAX package falls
back silently); ``"native"`` raises with the compiler's message when the
library does not build; :func:`dcrf_postprocess_3d` raises without it, as
in JAX.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from nnal_tpu_torch.core.device import resolve_device
from nnal_tpu_torch.runtime import crf_native

_BACKENDS = ("auto", "native", "pydensecrf", "torch")


def _gaussian_kernel_2d(radius: int, sigma: float, device) -> torch.Tensor:
    """``exp(-(dy^2 + dx^2) / (2 sigma^2))`` on the (2r+1)^2 window in f32,
    the centre zeroed (``crf.py:30-34``)."""
    ax = torch.arange(-radius, radius + 1, dtype=torch.float32,
                      device=device)
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    k = torch.exp(-(xx ** 2 + yy ** 2)
                  / torch.tensor(2.0 * sigma ** 2, device=device))
    k[radius, radius] = 0.0
    return k


@torch.no_grad()
def meanfield_crf_2d(posteriors: torch.Tensor, image: torch.Tensor,
                     iters: int = 5, radius: int = 5,
                     sxy_gauss: float = 3.0, w_gauss: float = 3.0,
                     sxy_bilat: float = 50.0, srgb: float = 4.0,
                     w_bilat: float = 10.0) -> torch.Tensor:
    """Mean-field dense-CRF refinement of an (H, W, C) posterior map on
    its device (``crf.py:37-92``); ``image`` (H, W) or (H, W, ch).  Each
    iteration sums, over the (2r+1)^2 - 1 offsets, the rolled marginals
    weighted by ``w_gauss * g(dy, dx) + w_bilat * exp(-(dy^2 + dx^2) /
    (2 sxy_bilat^2)) * exp(-|I - I_shift|^2 / (2 srgb^2))``, then
    ``q = softmax(-unary - (sum_c msg - msg))`` (Potts).  The per-offset
    weights do not depend on ``q``, so they are formed once."""
    dev = posteriors.device
    posteriors = posteriors.float()
    img = image if image.dim() == 3 else image[..., None]
    img = img.float()
    unary = -torch.log(torch.clamp(posteriors, min=1e-8))
    gk = _gaussian_kernel_2d(radius, sxy_gauss, dev)
    two_srgb2 = torch.tensor(2.0 * srgb ** 2, device=dev)
    w_g = torch.tensor(w_gauss, dtype=torch.float32, device=dev)
    w_b = torch.tensor(w_bilat, dtype=torch.float32, device=dev)
    terms = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            img_shift = torch.roll(img, (dy, dx), dims=(0, 1))
            spat_b = torch.exp(torch.tensor(
                -(dy * dy + dx * dx) / (2.0 * sxy_bilat ** 2),
                dtype=torch.float32, device=dev))
            app = torch.exp(-torch.sum((img - img_shift) ** 2, dim=-1)
                            / two_srgb2)
            w = (w_g * gk[dy + radius, dx + radius]
                 + (w_b * spat_b) * app[..., None])
            terms.append(((dy, dx), w))
    q = torch.softmax(-unary, dim=-1)
    for _ in range(int(iters)):
        msg = torch.zeros_like(q)
        for shift, w in terms:
            msg = msg + w * torch.roll(q, shift, dims=(0, 1))
        pairwise = torch.sum(msg, dim=-1, keepdim=True) - msg
        q = torch.softmax(-unary - pairwise, dim=-1)
    return q


def dcrf_postprocess_2d(posterior_map: np.ndarray, image: np.ndarray,
                        iters: int = 5, backend: str = "auto",
                        device=None) -> np.ndarray:
    """Binary-posterior wrapper (reference ``DCRF_postprocess_2D``,
    ``crf.py:95-134``): P(class 1) as a 2-D map in, the refined binary
    prediction (uint8) out.  ``device`` is where the ``torch`` backend
    runs (None: the card)."""
    if backend not in _BACKENDS:
        raise ValueError(f"unknown CRF backend {backend!r}")
    if backend in ("auto", "native"):
        try:
            crf_native.load()
        except RuntimeError as e:
            if backend == "native":
                raise
            warnings.warn(f"dense CRF falls back from the native solver: "
                          f"{e}")
        else:
            p1 = np.asarray(posterior_map, np.float32)
            posts = np.stack([1.0 - p1, p1], axis=-1)
            q = crf_native.dcrf2d_meanfield(
                posts, np.asarray(image, np.float32), iters=iters)
            return np.argmax(q, axis=-1).astype(np.uint8)
    if backend in ("auto", "pydensecrf"):
        try:
            import pydensecrf.densecrf  # noqa: F401
        except ImportError:
            if backend == "pydensecrf":
                raise
            warnings.warn("dense CRF falls back to the torch mean field: "
                          "pydensecrf does not import")
        else:
            return _pydensecrf_2d(posterior_map, image, iters)
    dev = resolve_device(device)
    p1 = torch.as_tensor(np.asarray(posterior_map, np.float32), device=dev)
    posts = torch.stack([1.0 - p1, p1], dim=-1)
    q = meanfield_crf_2d(posts, torch.as_tensor(
        np.asarray(image, np.float32), device=dev), iters=iters)
    return torch.argmax(q, dim=-1).cpu().numpy().astype(np.uint8)


def _pydensecrf_2d(posterior_map, image, iters):
    """The external solver at the reference's settings (``crf.py:137-151``)."""
    import pydensecrf.densecrf as dcrf
    from pydensecrf.utils import unary_from_softmax

    H, W = posterior_map.shape
    d = dcrf.DenseCRF2D(W, H, 2)
    softmax = np.stack([1 - posterior_map, posterior_map])
    d.setUnaryEnergy(unary_from_softmax(softmax))
    d.addPairwiseGaussian(sxy=3, compat=3)
    img8 = np.ascontiguousarray(
        np.repeat(np.asarray(image)[..., None], 3, axis=-1).astype(np.uint8))
    d.addPairwiseBilateral(sxy=50, srgb=4, rgbim=img8, compat=10)
    Q = d.inference(iters)
    return np.argmax(np.asarray(Q), axis=0).reshape(H, W).astype(np.uint8)


def dcrf_postprocess_3d(posterior_vol: np.ndarray, image_vol: np.ndarray,
                        iters: int = 5) -> np.ndarray:
    """Volumetric binary refinement through the native 3-D dense CRF
    (``crf.py:154-161``): P(class 1) (H, W, D) and guide intensities (H,
    W, D) in, the refined binary volume (uint8) out.  Raises without the
    native library (there is no torch 3-D fallback, as in JAX)."""
    try:
        crf_native.load()
    except RuntimeError as e:
        raise RuntimeError("native DenseCRF library unavailable (3D CRF has "
                           f"no fallback): {e}") from e
    p1 = np.asarray(posterior_vol, np.float32)
    posts = np.stack([1.0 - p1, p1], axis=-1)
    q = crf_native.dcrf3d_meanfield(posts, np.asarray(image_vol, np.float32),
                                    iters=iters)
    return np.argmax(q, axis=-1).astype(np.uint8)
