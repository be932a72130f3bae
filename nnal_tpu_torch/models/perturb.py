"""Input perturbation and output-perturbation uncertainty (AU_4U)
(counterpart of ``nnal_tpu/models/perturb.py``).

* :func:`perturb_input` — Gaussian noise and/or an in-plane rotation of
  the input batch (reference NN_extended.py:913-926);
* :func:`measure_output_perturbation` — the divergence between the
  model's posterior on the clean input and the (teacher) model's output
  on the perturbed one: ``L2``, the mean squared posterior difference, or
  ``CE``, the cross-entropy of the clean posterior against the perturbed
  logits' ``log_softmax`` (reference NN_extended.py:1502-1519), in f32.

Inputs are channels-last ``(b, H, W, C)`` as in JAX; ``nchw=True`` takes
the grid sweep's ``(b, C, H, W)``.  The noise is drawn channels-last
through :func:`_gaussian_noise` whatever the layout, so a test can feed
JAX's own normals.  The rotation is JAX's ``map_coordinates(order=1,
mode="nearest")`` written out: two linear taps per axis with clamped
indices, summed in JAX's order at f32 and rounded once to the input's
dtype.  ``F.grid_sample(mode="bilinear", padding_mode="border",
align_corners=True)`` computes the same function, but its round trip
through normalized coordinates moves the sample points by a few f32 ulps.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _gaussian_noise(shape, dtype, generator: torch.Generator,
                    device) -> torch.Tensor:
    """Standard normals of the channels-last ``shape`` at ``dtype``
    (``jax.random.normal(key, x.shape, x.dtype)``), drawn from
    ``generator``."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device)


def _linear_taps(coord: torch.Tensor, size: int):
    """``map_coordinates``' order-1 taps along one axis, ``mode='nearest'``
    clamping each tap's index: ``[(lower, 1 - w), (lower + 1, w)]``."""
    lower = torch.floor(coord)
    w_hi = coord - lower
    lo = lower.long()
    return [(lo.clamp(0, size - 1), 1.0 - w_hi),
            ((lo + 1).clamp(0, size - 1), w_hi)]


def rotate_2d(x: torch.Tensor, angle: float, nchw: bool = False
              ) -> torch.Tensor:
    """Bilinear in-plane rotation of a batch about the image center
    (reference ``tf.contrib.image.rotate``): each output pixel samples
    the input at the inversely rotated coordinates."""
    xc = x if nchw else x.permute(0, 3, 1, 2)
    H, W = xc.shape[2], xc.shape[3]
    dev = x.device
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    a = torch.tensor(float(angle), dtype=torch.float32).to(dev)
    c, s = torch.cos(a), torch.sin(a)
    src_y = c * (yy - cy) + s * (xx - cx) + cy
    src_x = -s * (yy - cy) + c * (xx - cx) + cx
    out = None
    for iy, wy in _linear_taps(src_y, H):
        for ix, wx in _linear_taps(src_x, W):
            term = (wy * wx) * xc[:, :, iy, ix].float()
            out = term if out is None else out + term
    out = out.to(x.dtype)
    return out if nchw else out.permute(0, 2, 3, 1)


def perturb_input(x: torch.Tensor, generator: Optional[torch.Generator],
                  gaussian_std: Optional[float] = None,
                  rotation_angle: Optional[float] = None,
                  nchw: bool = False) -> torch.Tensor:
    """Gaussian noise, then rotation (``perturb_input``).  The noise is
    scaled by ``gaussian_std`` rounded to the input's dtype, as JAX's
    weakly typed scalar is."""
    out = x
    if gaussian_std:
        b, *rest = x.shape
        nhwc = (b, rest[1], rest[2], rest[0]) if nchw else tuple(x.shape)
        noise = _gaussian_noise(nhwc, x.dtype, generator, x.device)
        if nchw:
            noise = noise.permute(0, 3, 1, 2)
        out = out + noise * noise.new_full((), gaussian_std)
    if rotation_angle:
        out = rotate_2d(out, rotation_angle, nchw)
    return out


@torch.no_grad()
def measure_output_perturbation(model, x: torch.Tensor,
                                generator: Optional[torch.Generator], *,
                                teacher=None, measure: str = "CE",
                                gaussian_std: Optional[float] = 0.05,
                                rotation_angle: Optional[float] = None,
                                nchw: bool = False) -> torch.Tensor:
    """Per-sample divergence between ``model``'s clean output and
    ``teacher``'s (``model`` itself when None) on the perturbed input.
    ``CE`` lower-bounds at the clean posterior's entropy, not 0 (the
    reference's exact form)."""
    clean = model(x, nchw=nchw)
    pert = (teacher if teacher is not None else model)(
        perturb_input(x, generator, gaussian_std, rotation_angle, nchw),
        nchw=nchw)
    p = clean.posteriors.float()
    if measure == "L2":
        q = pert.posteriors.float()
        return ((p - q) ** 2).sum(-1) / p.new_full((), p.shape[-1])
    if measure == "CE":
        logq = F.log_softmax(pert.logits.float(), dim=-1)
        return -(p * logq).sum(-1)
    raise ValueError(measure)
