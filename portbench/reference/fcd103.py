"""Plain PyTorch FC-DenseNet-103, written from the published layer table.

FC-DenseNet-103, "The One Hundred Layers Tiramisu" (Jegou et al.,
arXiv:1611.09326, Table 2), in 2-D, as the active-learning code of
Sourati et al. builds it (``FCDenseNet_103Layers``, ``create_NN.py:211``):

* a first 3x3 conv of 48 channels;
* dense blocks of 4, 5, 7, 10, 12 layers down, 15 in the bottleneck and
  12, 10, 7, 5, 4 up, growth 16.  A layer is BN, ReLU, a 3x3 conv of 16
  channels, then dropout; it reads the concatenation of the block's input
  and every earlier layer's output of the block;
* transition down: BN, ReLU, a 1x1 conv that keeps the channel count,
  dropout, then a 2x2 max pool of stride 2;
* transition up: a 3x3 transposed conv of stride 2 over the new features
  of the block below (16 times its layer count), then the skip from the
  same resolution is concatenated after it;
* a last 1x1 conv to ``nclass`` channels over the last block's input and
  outputs.

Two departures from the paper's table follow the Sourati et al. code:
ReLU follows the first conv and each transposed conv.  Batch norm
normalizes by the running statistics in eval mode, with epsilon 1e-3.

A transposed conv here is the input dilated by its stride, padded by (2,
1) and correlated with the kernel as stored, ``(out, in, 3, 3)``: the
definition of ``lax.conv_transpose`` with SAME padding.  Weights are a
dict ``name -> tensor`` (conv ``(out, in, k, k)``; a BN-led layer also has
``<name>.gamma`` / ``<name>.beta`` over its input channels) and the
running statistics a dict ``name -> {"mean", "var"}``.  Nothing here
imports the program under test.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

GROWTH = 16
DEPTHS = (4, 5, 7, 10, 12, 15)
FIRST = 48
BN_EPS = 1e-3


def layers(channels: int, nclass: int, growth: int = GROWTH,
           depths=DEPTHS) -> List[Tuple]:
    """The layer table: ``(kind, name, sources, in_channels, out_channels)``
    rows, ``kind`` one of ``first``, ``dense``, ``td``, ``pool``, ``tu``,
    ``last``.  ``sources`` name the outputs concatenated into the input."""
    rows: List[Tuple] = [("first", "first_conv", (), channels, FIRST)]
    width = {"first_conv": FIRST}

    def block(tag, n, inputs):
        outs = []
        for i in range(n):
            name = f"{tag}_l{i}"
            srcs = tuple(inputs + outs)
            rows.append(("dense", name, srcs, sum(width[s] for s in srcs),
                         growth))
            width[name] = growth
            outs.append(name)
        return outs

    skips = []
    inputs = ["first_conv"]
    for d, n in enumerate(depths[:-1]):
        outs = block(f"down{d}", n, inputs)
        srcs = tuple(inputs + outs)
        c = sum(width[s] for s in srcs)
        name = f"down{d}_cat"
        rows.append(("td", name, srcs, c, c))
        width[name] = c
        skips.append(name)
        rows.append(("pool", f"down{d}_pool", (name,), c, c))
        width[f"down{d}_pool"] = c
        inputs = [f"down{d}_pool"]
    outs = block("mid", depths[-1], inputs)
    for d in reversed(range(len(depths) - 1)):
        name = f"up{d}_T"
        c = sum(width[s] for s in outs)
        rows.append(("tu", name, tuple(outs), c, growth * len(outs)))
        width[name] = growth * len(outs)
        inputs = [name, skips[d]]
        outs = block(f"up{d}", depths[d], inputs)
    srcs = tuple(inputs + outs)
    rows.append(("last", "last", srcs, sum(width[s] for s in srcs), nclass))
    return rows


def param_shapes(channels: int, nclass: int) -> Dict[str, Tuple[int, ...]]:
    """``name -> shape`` of every weight, bias and BN scale and shift."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    for kind, name, _, cin, cout in layers(channels, nclass):
        if kind == "pool":
            continue
        k = 3 if kind in ("first", "dense", "tu") else 1
        shapes[f"{name}.weight"] = (cout, cin, k, k)
        shapes[f"{name}.bias"] = (cout,)
        if kind in ("dense", "td"):
            shapes[f"{name}.gamma"] = (cin,)
            shapes[f"{name}.beta"] = (cin,)
    return shapes


def bn_names(channels: int, nclass: int) -> Iterator[Tuple[str, int]]:
    """``(name, width)`` of every layer that holds running statistics."""
    for kind, name, _, cin, _ in layers(channels, nclass):
        if kind in ("dense", "td"):
            yield name, cin


def _bn_relu(h, params, stats, name):
    mean = stats[name]["mean"].view(1, -1, 1, 1)
    var = stats[name]["var"].view(1, -1, 1, 1)
    h = (h - mean) / torch.sqrt(var + BN_EPS)
    h = h * params[f"{name}.gamma"].view(1, -1, 1, 1) \
        + params[f"{name}.beta"].view(1, -1, 1, 1)
    return F.relu(h)


def _transposed(h, w, b):
    n, c, H, W = h.shape
    up = h.new_zeros((n, c, 2 * H - 1, 2 * W - 1))
    up[:, :, ::2, ::2] = h
    return F.conv2d(F.pad(up, (2, 1, 2, 1)), w, b)


def forward(params: Dict[str, torch.Tensor], stats: Dict[str, Dict],
            x: torch.Tensor, nclass: int) -> torch.Tensor:
    """Logits (n, nclass, H, W) of ``x`` (n, channels, H, W), eval mode."""
    out: Dict[str, torch.Tensor] = {}
    h = x
    for kind, name, srcs, _, _ in layers(x.shape[1], nclass):
        if srcs:
            h = torch.cat([out[s] for s in srcs], dim=1) if len(srcs) > 1 \
                else out[srcs[0]]
        w, b = params.get(f"{name}.weight"), params.get(f"{name}.bias")
        if kind == "first":
            h = F.relu(F.conv2d(h, w, b, padding=1))
        elif kind == "dense":
            h = F.conv2d(_bn_relu(h, params, stats, name), w, b, padding=1)
        elif kind == "td":
            h = F.conv2d(_bn_relu(h, params, stats, name), w, b)
        elif kind == "pool":
            h = F.max_pool2d(h, 2, 2)
        elif kind == "tu":
            h = F.relu(_transposed(h, w, b))
        else:
            h = F.conv2d(h, w, b)
        out[name] = h
    return h
