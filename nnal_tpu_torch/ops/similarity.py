"""K1: row-max cosine similarity — the port of
``nnal_tpu/ops/similarity_pallas.py::max_similarity_pallas``.

``rowmax_similarity(P, R)[i] = max_j P[i] . R[j]`` over L2-normalized rows.
On a CUDA tensor it launches the hand-written kernel in
``csrc/rowmax_similarity.cu`` (see its header for the bound and design)
or raises; on a CPU tensor it runs the plain version below.  There is no
fallback from the card to the plain version.

The kernel's main path computes in split-precision TF32 on the tensor
cores; :func:`rowmax_similarity_3xtf32` emulates that arithmetic in plain
PyTorch so that the CPU tests fix its error budget (about 2^-21 |a||b| per
product, dropped ``lo . lo'`` term included).
"""

from __future__ import annotations

import torch

from nnal_tpu_torch.ops._build import INT, VOIDP, CudaKernel, stream_ptr

KERNEL = CudaKernel("rowmax_similarity", "rowmax_similarity.cu",
                    "rowmax_similarity_f32",
                    [VOIDP, VOIDP, VOIDP, VOIDP, INT, INT, INT, INT, VOIDP],
                    extra_flags=("-lineinfo",))

# source of the Pallas kernel this replaces (for reports)
REPLACES = "nnal_tpu/ops/similarity_pallas.py:74"


def rowmax_similarity_plain(P: torch.Tensor, R: torch.Tensor,
                            tile: int = 4096) -> torch.Tensor:
    """Plain PyTorch version: tiled ``(P @ R.T).amax(1)``, so the (n, m)
    block is bounded to ``tile`` rows at a time."""
    out = [torch.matmul(P[lo:lo + tile], R.T).amax(dim=1)
           for lo in range(0, P.shape[0], tile)]
    return torch.cat(out) if out else P.new_empty((0,))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does: add half of the 13 dropped
    bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """``x = hi + lo`` with ``hi = tf32(x)`` and ``lo = tf32(x - hi)``
    (``x - hi`` is exact in float32)."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def rowmax_similarity_3xtf32(P: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Plain emulation of the kernel's arithmetic, for tests: the three
    products ``hi.hi' + hi.lo' + lo.hi'`` of the TF32 halves, summed in
    float64 so that only the split's own error remains."""
    ph, pl = (t.double() for t in split_tf32(P))
    rh, rl = (t.double() for t in split_tf32(R))
    return (ph @ rh.T + ph @ rl.T + pl @ rh.T).amax(dim=1).float()


def _check(P, R):
    if P.dim() != 2 or R.dim() != 2 or P.shape[1] != R.shape[1]:
        raise ValueError(f"need P (n, d) and R (m, d); got {tuple(P.shape)}"
                         f" and {tuple(R.shape)}")
    if P.dtype != torch.float32 or R.dtype != torch.float32:
        raise TypeError(f"float32 only; got {P.dtype}, {R.dtype}")
    if P.device != R.device:
        raise ValueError(f"P on {P.device}, R on {R.device}")
    if R.shape[0] == 0:
        raise ValueError("R has no rows: the row max is undefined")


def rowmax_similarity(P: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """(n,) max dot product of each row of ``P`` against all rows of ``R``
    (rows pre-normalized).  CUDA tensors launch K1; CPU tensors take the
    plain version."""
    _check(P, R)
    if P.device.type == "cpu":
        return rowmax_similarity_plain(P, R)
    if P.device.type != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    if not (P.is_contiguous() and R.is_contiguous()):
        raise ValueError("rowmax_similarity needs contiguous P and R")
    n, d = P.shape
    m = R.shape[0]
    if max(n, m, d) >= 2 ** 31:
        raise ValueError("dimensions must fit in int32")
    out = torch.empty((n,), dtype=torch.float32, device=P.device)
    # TMA reads P in place and needs 16-byte aligned rows; anything else
    # takes the f32 FMA path.  R is read once, into R_hi and R_lo, split
    # inside the call
    vec = d % 4 == 0 and P.data_ptr() % 16 == 0
    scratch = (torch.empty((2, m, d), dtype=torch.float32, device=P.device)
               if vec else None)
    # the C entry point reads the SM count and sets its shared-memory
    # attribute on the current device, and launches there: make it P's
    with torch.cuda.device(P.device):
        KERNEL.launch(P.data_ptr(), R.data_ptr(), out.data_ptr(),
                      scratch.data_ptr() if vec else None, n, m, d,
                      int(vec), stream_ptr(P))
    return out


def normalize_rows(F: torch.Tensor) -> torch.Tensor:
    """L2-normalize rows; zero rows stay zero (norm clamped at 1e-12)."""
    return F / torch.clamp(torch.linalg.norm(F, dim=1, keepdim=True),
                           min=1e-12)


def max_similarity(pool: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Normalize + row max: the counterpart of the TPU wrapper
    ``max_similarity``, except that zero rows give 0 here (the clamp of
    the XLA path) where the TPU wrapper divides by a zero norm.  Rows are
    normalized in their own dtype (bf16 features under ``model.dtype:
    bfloat16``) and handed to K1 as f32, the JAX order
    (``similarity_pallas.py:111-123``, ``:89-90``)."""
    return rowmax_similarity(normalize_rows(pool).float().contiguous(),
                             normalize_rows(ref).float().contiguous())
