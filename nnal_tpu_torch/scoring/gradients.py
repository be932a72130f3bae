"""'Sum'-shrunk per-sample class gradients for Fisher-information querying
(counterpart of ``nnal_tpu/scoring/gradients.py:32-339``).

The epsilon trick: 'sum' shrinkage needs only the sum of gradient entries
per layer.  With ``f(E) = log p_c(x_i; {W_l + E[i, l], b_l + E[i, l]})``,
``df/dE[i, l]`` at ``E = 0`` is exactly layer l's entry-sum of
``d log p_c(x_i) / d theta``.  The perturbation is linear in E:

* conv: ``z = conv(h, W) + b + E[:, l] * (conv(h, ones) + 1)``;
* fc:   ``z = h W + b + E[:, l] * (sum(h) + 1)``;

so one batch forward with an injected ``(b, L)`` matrix E and one backward
per class yield all L shrunk components of every sample.  The backward is
taken with respect to E only, on detached parameters: no weight-gradient
GEMM or convolution runs, only input gradients (about one forward's cost).

The forward is driven off the :class:`~nnal_tpu_torch.models.cnn.CNN`
module itself (its submodules' weights and its ``pad_input``, so a
conv's ones-filter sees the same SAME padding as the conv, asymmetric
where XLA's is).  Not ported: the opt-in ``NNAL_CONV1_MM`` first-conv lowering (a TPU
matrix-unit workaround).

The full per-sample gradients (:func:`per_sample_grads`, ``vmap`` of
``grad`` through ``functional_call``), the diagonal Fisher and the
host-side shrinkage of a whole gradient (:func:`shrink_gradient_pytree`)
sit at the end (``gradients.py:342-406``).

``compute_dtype=torch.bfloat16`` keeps activations in bf16 between layers
(``gradients.py:85-233``): each layer casts its weight to the activation's
dtype, the bias stays f32, ``z = conv(h, W) + b + E * (wsum + 1)`` is formed
in f32 and cast to bf16 before a relu (after any other activation), and
``wsum`` and the fc row sum are f32.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from nnal_tpu_torch.data.patches import gather_patches_normalized
from nnal_tpu_torch.models.bridge import to_jax_tensors
from nnal_tpu_torch.models.cnn import (
    conv_f32acc,
    conv_nd,
    linear_f32acc,
    to_channels_first,
    to_channels_last,
)


def grad_param_layers(model) -> List[str]:
    """Layers carrying W/b, in spec order (the reference's grad target
    set)."""
    return [l.name for l in model.spec.layers if l.kind in ("conv", "fc")]


def layer_sizes(model) -> np.ndarray:
    """numel(W) + numel(b) per grad layer — the shrinkage denominator
    (reference NNAL_tools.py:784-796)."""
    return np.array([getattr(model, n).weight.numel()
                     + getattr(model, n).bias.numel()
                     for n in grad_param_layers(model)])


def _cast_act(model, layer, z, cd):
    """``layer``'s activation with the compute-dtype cast where the JAX
    package puts it (``gradients.py:85-100``): before a relu (rounding
    keeps the sign, so relu∘round == round∘relu and the saved residual is
    bf16), after any other activation."""
    act = "A" in layer.op_order
    if cd is None:
        return model.act(z) if act else z
    if model.spec.activation == "relu":
        z = z.to(cd)
        return model.act(z) if act else z
    return (model.act(z) if act else z).to(cd)


def _eps_layer(model, layer, h, E, li, cd=None):
    """One eps-injected layer on channels-first ``h`` (2-D or 3-D);
    returns ``(h_out, li_out)``.

    ``wsum`` (the ones-filter conv, or the row sum of an fc input) is
    computed without autograd: its only path into the gradient is
    ``E * d wsum / dh``, which is exactly zero at E = 0, so dropping it
    drops one input-gradient conv per layer and changes no value.  It is
    accumulated in f32 whatever the activations' dtype, as the JAX
    package's ``preferred_element_type=f32`` ones-filter conv is.  The
    activation is ``model.act``; ``torch.relu``'s backward already keeps
    its output, not its input, which is what the JAX package's
    ``_relu_save_output`` custom VJP arranges."""
    if layer.kind == "pool":
        pool = F.max_pool3d if h.dim() == 5 else F.max_pool2d
        return pool(model.pad_input(layer, h), layer.ksize,
                    layer.strides), li
    mod = getattr(model, layer.name)
    W, b = mod.weight.detach(), mod.bias.detach()
    if layer.kind == "conv":
        h = model.pad_input(layer, h)
        conv = conv_nd(h)
        bias = b.view((-1,) + (1,) * (h.dim() - 2))
        if cd is None:
            z = conv(h, W, b, mod.stride, mod.padding)
        else:
            z = (conv_f32acc(h, W.to(h.dtype), mod.stride, mod.padding)
                 + bias)
        with torch.no_grad():
            # the window sum over every input channel: the f32 channel sum,
            # then one 1 -> 1 channel ones conv (a C_in -> 1 conv runs as
            # an implicit GEMM that wastes almost all of its tile)
            ones = torch.ones((1, 1) + tuple(W.shape[2:]),
                              dtype=torch.float32, device=h.device)
            wsum = conv(h.sum(1, keepdim=True, dtype=torch.float32),
                        ones, None, mod.stride, mod.padding)
        z = z + E[:, li].view((-1,) + (1,) * (h.dim() - 1)) * (wsum + 1.0)
    elif layer.kind == "fc":
        if h.dim() > 2:
            # fc layers flatten channels-last, as models/cnn.py does
            h = to_channels_last(h).reshape(h.shape[0], -1)
        if cd is None:
            z = F.linear(h, W, b)
        else:
            z = linear_f32acc(h, W.to(h.dtype)) + b
        s = h.detach().float().sum(1, keepdim=True)
        z = z + E[:, li:li + 1] * (s + 1.0)
    else:
        raise NotImplementedError(
            f"eps-injected forward does not support {layer.kind!r}; use "
            "shrunk_class_grads_persample")
    return _cast_act(model, layer, z, cd), li + 1


def _segments(layers):
    """The layer stack split after each pool (the remat segments)."""
    segs, cur = [], []
    for layer in layers:
        cur.append(layer)
        if layer.kind == "pool":
            segs.append(cur)
            cur = []
    if cur:
        segs.append(cur)
    return segs


def _apply_with_eps(model, h, E, remat: bool = False, compute_dtype=None
                    ) -> torch.Tensor:
    """f32 logits of the eps-injected forward on channels-first ``h`` (see
    the module
    docstring).  ``remat=True`` checkpoints each segment that ends at a
    pool, so the backward keeps only the segment inputs and recomputes the
    convolutions inside."""
    cd = compute_dtype
    h = h if cd is None else h.to(cd)
    li = 0
    for seg in _segments(model.spec.layers):
        def run(hh, EE, _seg=tuple(seg), _li=li):
            for layer in _seg:
                hh, _li = _eps_layer(model, layer, hh, EE, _li, cd)
            return hh

        h = checkpoint(run, h, E, use_reentrant=False) if remat \
            else run(h, E)
        li += sum(1 for l in seg if l.kind != "pool")
    return h.float()


def shrunk_class_grads_with_logits(model, x: torch.Tensor,
                                   compute_dtype=None, remat: bool = False,
                                   nchw: bool = False):
    """'Sum'-shrunk per-class log-posterior gradients of a patch batch and
    the forward's logits: ``((b, c, L), (b, c))``.  Per layer, the mean of
    the entries of ``d log p(y=c|x_i) / d theta_layer`` (reference
    ``shrink_gradient(..., 'sum')``, NNAL_tools.py:778-831).

    Classes 1..c-1 take one backward pass each; class 0 comes from the
    softmax zero-sum identity ``sum_c p_c grad(log p_c) = 0``, which holds
    per sample: ``g0 = -sum_{c>=1} p_c g_c / max(p0, 1e-12)``.  ``x`` is
    channels-last ``(b, d1, d2, C)`` or ``(b, d1, d2, d3, C)`` unless
    ``nchw``."""
    h = x if nchw else to_channels_first(x)
    nclass = model.spec.nclass
    sizes = torch.as_tensor(layer_sizes(model), dtype=torch.float32,
                            device=x.device)
    E = torch.zeros((x.shape[0], len(sizes)), dtype=torch.float32,
                    device=x.device, requires_grad=True)
    rest = []
    with torch.enable_grad():
        logits = _apply_with_eps(model, h, E, remat, compute_dtype)
        logp = torch.log_softmax(logits, dim=-1)
        for c in range(1, nclass):
            # the sum over samples: d/dE[i, l] touches only sample i
            g, = torch.autograd.grad(logp[:, c].sum(), E,
                                     retain_graph=c < nclass - 1)
            rest.append(g)
    logits = logits.detach()
    posts = torch.softmax(logits, dim=-1)
    grads_rest = torch.stack(rest)                     # (c-1, b, L)
    weighted = torch.einsum("cb,cbl->bl", posts[:, 1:].T, grads_rest)
    g0 = -weighted / posts[:, 0].clamp_min(1e-12)[:, None]
    grads = torch.cat([g0[None], grads_rest])          # (c, b, L)
    return grads.permute(1, 0, 2) / sizes, logits


def shrunk_class_grads(model, x: torch.Tensor, compute_dtype=None,
                       remat: bool = False, nchw: bool = False
                       ) -> torch.Tensor:
    """(b, c, L) 'sum'-shrunk class gradients (see
    :func:`shrunk_class_grads_with_logits`)."""
    return shrunk_class_grads_with_logits(model, x, compute_dtype, remat,
                                          nchw)[0]


def shrunk_class_grads_persample(model, x: torch.Tensor,
                                 nchw: bool = False) -> torch.Tensor:
    """Oracle: per-sample parameter perturbation through
    ``torch.func.functional_call``, ``jacrev`` over the L epsilons and
    ``vmap`` over samples (slow; kept for the parity tests)."""
    from torch.func import functional_call, jacrev, vmap

    names = grad_param_layers(model)
    sizes = torch.as_tensor(layer_sizes(model), dtype=torch.float32,
                            device=x.device)
    params = {k: v.detach() for k, v in model.named_parameters()}

    def logp(eps, xi):
        p = dict(params)
        for j, n in enumerate(names):
            p[f"{n}.weight"] = params[f"{n}.weight"] + eps[j]
            p[f"{n}.bias"] = params[f"{n}.bias"] + eps[j]
        out = functional_call(model, p, (xi[None],), {"nchw": nchw})
        return torch.log_softmax(out.logits, dim=-1)[0]       # (c,)

    eps0 = torch.zeros(len(names), dtype=torch.float32, device=x.device)
    return vmap(jacrev(logp), in_dims=(None, 0))(eps0, x) / sizes


def gather_shrunk_a_matrices(model, padded, inds, mu, sd, patch_shape,
                             orig_shape, posts_p1, diag_load=1e-5,
                             compute_dtype=None) -> torch.Tensor:
    """The FI scoring tail on the device: candidate patch gather and
    normalization (kernel K2 on the card) -> 'sum'-shrunk class gradients
    -> conditional-FI A-matrices ``(B, L, L)``."""
    from nnal_tpu_torch.scoring.fisher import a_matrices

    x = gather_patches_normalized(padded, inds, mu, sd, patch_shape,
                                  orig_shape)
    shrunk = shrunk_class_grads(model, x, compute_dtype)
    return a_matrices(shrunk, posts_p1, diag_load)


def per_sample_grads(model, params, x, y_onehot):
    """Full per-sample CE gradients by ``vmap(grad)``: a parameter dict
    (keyed as ``named_parameters``) with a leading batch axis (the
    reference takes one ``sess.run`` per sample, model_utils.py:294-330).

    cuDNN is off here: for ``vmap``'s grouped weight-gradient convolutions
    it picked, at 4 rows of PW1 25x25x2, an algorithm that parted from the
    host by 1.4e-4 (relative; 1e-6 at 8 rows), where PyTorch's own
    convolution keeps f32 accuracy (``chip_smoke.py``'s second-order
    phase holds the card to the host)."""
    from torch.func import functional_call, grad, vmap

    def loss_one(p, xi, yi):
        logits = functional_call(model, p, (xi[None],)).logits
        return -(yi * torch.log_softmax(logits, dim=-1)[0]).sum()

    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        return vmap(grad(loss_one), in_dims=(None, 0, 0))(params, x,
                                                          y_onehot)


def diagonal_fisher(model, params, X, Y_onehot, chunk: int = 64):
    """Diagonal Fisher: the mean over samples of squared per-sample
    gradients, per parameter (reference ``diagonal_Fisher``,
    model_utils.py:294-330), in chunks of ``chunk`` rows (a chunk holds
    ``chunk`` full gradients)."""
    acc, seen = None, 0
    for lo in range(0, X.shape[0], chunk):
        g = per_sample_grads(model, params, X[lo:lo + chunk],
                             Y_onehot[lo:lo + chunk])
        sq = {n: (t.float() ** 2).sum(0) for n, t in g.items()}
        acc = sq if acc is None else {n: acc[n] + sq[n] for n in acc}
        seen += g[next(iter(g))].shape[0]
    return {n: t / seen for n, t in acc.items()}


def shrink_gradient_pytree(grads, spec, method: str = "sum", rng=None,
                           nppl: int = 0) -> np.ndarray:
    """Shrink one full gradient (a dict keyed as ``named_parameters``) on
    the host (reference NNAL_tools.py:778-831), per layer in spec order:
    'sum' (the mean of the layer's entries), 'max' (its entry of largest
    magnitude), 'rand' (``rng.choice`` of ``nppl`` entries).  Each layer is
    raveled as ``[W.ravel(), b]`` in the JAX package's layouts (HWIO,
    (in, out)), so 'rand' picks the entries JAX picks from the same
    generator."""
    jt = to_jax_tensors(grads)
    out = []
    for name in [l.name for l in spec.layers if l.name in jt
                 and "W" in jt[l.name]]:
        cat = np.concatenate([jt[name]["W"].cpu().numpy().ravel(),
                              jt[name]["b"].cpu().numpy().ravel()])
        if method == "sum":
            out.append(cat.sum() / cat.size)
        elif method == "max":
            out.append(cat[np.argmax(np.abs(cat))])
        elif method == "rand":
            idx = rng.choice(cat.size, size=min(nppl, cat.size),
                             replace=False)
            out.extend(cat[idx])
        else:
            raise ValueError(method)
    return np.asarray(out)
