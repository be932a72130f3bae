"""Architecture specification language + model factories.

The reference builds CNNs from layer dicts in two generations:

* v1: ``{name: [depth,'conv',ksize] | [n,'fc'] | [size,'pool']}``
  (NN.py:56-188) — used by ``create_PW1`` / ``create_VGG19`` (NN.py:1217-1355);
* v2: ``{name: [type, specs, op_order]}`` with op order 'M'/'B'/'A'
  (main / batch-norm / activation), 2D+3D conv, transposed conv, skip
  connections and probed branches (NN_extended.py:20-601), used by
  ``create_NN.py`` factories incl. FC-DenseNet-103 (create_NN.py:211).

Here both generations collapse into one typed spec: a list of
:class:`Layer` rows (with v2-style ``op_order`` and skip ``sources``) inside
a :class:`CNNSpec`.  Factories reproduce the reference architectures —
PW1 (NN.py:1319-1355), VGG-16/19 (create_NN.py:16, NN.py:1268), DenseNet
2-block (create_NN.py:136), FC-DenseNet-103 "Tiramisu" (create_NN.py:211).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Layer:
    name: str
    kind: str                       # 'conv' | 'convT' | 'fc' | 'pool' | 'avgpool'
    out: Optional[int] = None       # channels (conv) or width (fc)
    ksize: Tuple[int, ...] = ()     # spatial kernel (2- or 3-tuple)
    strides: Tuple[int, ...] = ()   # defaults: conv 1s, pool = ksize
    padding: str = "SAME"
    op_order: str = "MA"            # subset/order of 'M'(main) 'B'(bn) 'A'(act)
    sources: Tuple[str, ...] = ()   # skip inputs combined before this layer
    combine: str = "concat"         # 'concat' | 'sum'
    dropout: float = 0.0            # per-layer dropout rate (applied to output)


@dataclass(frozen=True)
class CNNSpec:
    name: str
    layers: Tuple[Layer, ...]
    input_shape: Tuple[int, ...]    # sample shape without batch, channels-last
    nclass: int
    feature_layer: Optional[int] = None  # index of feature-probe layer
    probes: Tuple[int, ...] = ()
    fcn: bool = False               # dense-prediction (per-pixel) head
    aleatoric: bool = False         # last layer emits [logits, log-sigma]
    activation: str = "relu"

    @property
    def spatial_rank(self) -> int:
        return len(self.input_shape) - 1

    def layer_index(self, name: str) -> int:
        for i, l in enumerate(self.layers):
            if l.name == name:
                return i
        raise KeyError(name)


def _conv(name, out, k, op_order="MA", strides=None, dropout=0.0, sources=(),
          combine="concat", padding="SAME"):
    k = tuple(k) if isinstance(k, (tuple, list)) else (k, k)
    return Layer(name, "conv", out, k, tuple(strides) if strides else
                 tuple(1 for _ in k), padding, op_order, tuple(sources),
                 combine, dropout)


def _pool(name, size, strides=None):
    size = tuple(size) if isinstance(size, (tuple, list)) else (size, size)
    return Layer(name, "pool", None, size,
                 tuple(strides) if strides else size, "SAME")


def _fc(name, out, dropout=0.0, op_order="MA"):
    return Layer(name, "fc", out, (), (), "VALID", op_order, (), "concat",
                 dropout)


# --------------------------------------------------------------------------- #
# factories
# --------------------------------------------------------------------------- #
def create_pw1(nclass: int, dropout_rate: float,
               patch_shape: Tuple[int, int, int]) -> CNNSpec:
    """The patch-wise segmentation workhorse PW1 (reference ``create_PW1``,
    NN.py:1319-1355): conv24-conv32-pool-conv48-conv96-pool-fc4096-fc4096-fcC
    with dropout on layers [6,7,8] (the FCs) and feature layer = fc2."""
    dr = dropout_rate
    layers = (
        _conv("conv1", 24, (5, 5)),
        _conv("conv2", 32, (5, 5)),
        _pool("max1", (2, 2)),
        _conv("conv3", 48, (3, 3)),
        _conv("conv4", 96, (3, 3)),
        _pool("max2", (2, 2)),
        _fc("fc1", 4096, dropout=dr),
        _fc("fc2", 4096, dropout=dr),
        # head is linear ('M'): softmax runs on raw logits; dropout on the
        # head output mirrors the reference's dropout list [6,7,8]
        _fc("fc3", nclass, dropout=dr, op_order="M"),
    )
    # input: (d1, d2, m*d3) patches, channels-last
    return CNNSpec("PW1", layers, tuple(patch_shape), nclass,
                   feature_layer=7, probes=(4,))


def create_vgg(nclass: int, dropout_rate: float, version: int = 19,
               input_shape=(224, 224, 3)) -> CNNSpec:
    """VGG-16/19 (reference NN.py:1268-1317, create_NN.py:16-134)."""
    cfg16 = [(64, 2), "p", (128, 2), "p", (256, 3), "p", (512, 3), "p",
             (512, 3), "p"]
    cfg19 = [(64, 2), "p", (128, 2), "p", (256, 4), "p", (512, 4), "p",
             (512, 4), "p"]
    cfg = cfg19 if version == 19 else cfg16
    layers: List[Layer] = []
    ci, pi = 0, 0
    for item in cfg:
        if item == "p":
            pi += 1
            layers.append(_pool(f"max{pi}", (2, 2)))
        else:
            ch, reps = item
            for _ in range(reps):
                ci += 1
                layers.append(_conv(f"conv{ci}", ch, (3, 3)))
    layers += [_fc("fc1", 4096, dropout=dropout_rate),
               _fc("fc2", 4096, dropout=dropout_rate),
               _fc("fc3", nclass, op_order="M")]
    return CNNSpec(f"VGG{version}", tuple(layers), tuple(input_shape), nclass,
                   feature_layer=len(layers) - 2)


def create_densenet_2block(nclass: int, growth: int = 12, depth: int = 4,
                           input_shape=(32, 32, 3),
                           dropout_rate: float = 0.0) -> CNNSpec:
    """DenseNet with 2 dense blocks + transition (reference
    ``DenseNet_2block``, create_NN.py:136-209): each dense-block layer
    concatenates all previous outputs in the block."""
    layers: List[Layer] = [_conv("conv0", 2 * growth, (3, 3))]
    prev = ["conv0"]
    for b in range(2):
        for i in range(depth):
            nm = f"b{b}_conv{i}"
            layers.append(_conv(nm, growth, (3, 3), op_order="BAM",
                                sources=tuple(prev) if len(prev) > 1 else (),
                                dropout=dropout_rate))
            prev.append(nm)
        if b == 0:
            layers.append(_conv("trans_conv", 2 * growth, (1, 1),
                                op_order="BAM",
                                sources=tuple(prev) if len(prev) > 1 else ()))
            layers.append(_pool("trans_pool", (2, 2)))
            prev = ["trans_pool"]
    layers.append(_pool("gap", (2, 2)))
    layers.append(_fc("fc_out", nclass, op_order="M"))
    return CNNSpec("DenseNet2B", tuple(layers), tuple(input_shape), nclass,
                   feature_layer=len(layers) - 2)


def create_tiramisu103(nclass: int, input_shape,
                       growth: int = 16,
                       depths: Sequence[int] = (4, 5, 7, 10, 12, 15),
                       dropout_rate: float = 0.1) -> CNNSpec:
    """FC-DenseNet-103 "Tiramisu" for dense segmentation (reference
    ``FCDenseNet_103Layers``, create_NN.py:211-461): dense blocks down a
    pooling path and up a transposed-conv path, skip concatenations across,
    per-layer dropout.  2D or 3D by ``input_shape`` rank (3 -> 2D + C)."""
    rank = len(input_shape) - 1
    k = tuple([3] * rank)
    one = tuple([1] * rank)
    two = tuple([2] * rank)
    layers: List[Layer] = [
        Layer("first_conv", "conv", 48, k, one, "SAME", "MA")]
    dr = dropout_rate

    def dense_block(tag, n_layers, inputs):
        outs = []
        for i in range(n_layers):
            nm = f"{tag}_l{i}"
            srcs = tuple(inputs + outs)
            layers.append(Layer(nm, "conv", growth, k, one, "SAME", "BAM",
                                srcs if len(srcs) > 1 else (), "concat", dr))
            outs.append(nm)
        return outs

    skips = []  # names whose outputs concat across to the up path
    inputs = ["first_conv"]
    # down path
    for d, n in enumerate(depths[:-1]):
        outs = dense_block(f"down{d}", n, inputs)
        concat_name = f"down{d}_cat"
        # transition down: 1x1 conv (BAM) + pool over [inputs + outs]
        layers.append(Layer(concat_name, "conv", None, tuple([1] * rank), one,
                            "SAME", "BAM", tuple(inputs + outs), "concat", dr))
        skips.append(concat_name)
        layers.append(Layer(f"down{d}_pool", "pool", None, two, two, "SAME"))
        inputs = [f"down{d}_pool"]
    # bottleneck
    outs = dense_block("mid", depths[-1], inputs)
    # up path
    for d in reversed(range(len(depths) - 1)):
        n = depths[d]
        up_name = f"up{d}_T"
        layers.append(Layer(up_name, "convT", growth * len(outs), k, two,
                            "SAME", "MA", tuple(outs), "concat"))
        inputs = [up_name, skips[d]]
        outs = dense_block(f"up{d}", n, inputs)
    layers.append(Layer("last", "conv", nclass, tuple([1] * rank), one,
                        "SAME", "M", tuple(inputs + outs), "concat"))
    return CNNSpec("FCDenseNet103", tuple(layers), tuple(input_shape), nclass,
                   feature_layer=len(layers) - 2, fcn=True)


def create_alexnet(nclass: int, dropout_rate: float = 0.5,
                   input_shape=(227, 227, 3)) -> CNNSpec:
    """AlexNet-shaped spec (reference wraps an external pretrained Kratzert
    AlexNet, NN.py:1033-1232, with a hard-coded module path that is not
    vendored; here the architecture is a first-class spec — weights can be
    imported through the h5 shim)."""
    layers = (
        _conv("conv1", 96, (11, 11), strides=(4, 4), padding="VALID"),
        _pool("max1", (3, 3), strides=(2, 2)),
        _conv("conv2", 256, (5, 5)),
        _pool("max2", (3, 3), strides=(2, 2)),
        _conv("conv3", 384, (3, 3)),
        _conv("conv4", 384, (3, 3)),
        _conv("conv5", 256, (3, 3)),
        _pool("max5", (3, 3), strides=(2, 2)),
        _fc("fc6", 4096, dropout=dropout_rate),
        _fc("fc7", 4096, dropout=dropout_rate),
        _fc("fc8", nclass, op_order="M"),
    )
    return CNNSpec("AlexNet", layers, tuple(input_shape), nclass,
                   feature_layer=9)


def create_model(model_name: str, *, nclass: int, dropout_rate: float = 0.5,
                 patch_shape=None, input_shape=None, **kw) -> CNNSpec:
    """Factory dispatch (reference ``create_model``, NN.py:1217-1246)."""
    if model_name in ("PW", "PW1"):
        return create_pw1(nclass, dropout_rate, patch_shape)
    if model_name == "Alex":
        return create_alexnet(nclass, dropout_rate,
                              input_shape or (227, 227, 3))
    if model_name in ("VGG19", "VGG16"):
        return create_vgg(nclass, dropout_rate, int(model_name[3:]),
                          input_shape or (224, 224, 3))
    if model_name == "DenseNet":
        return create_densenet_2block(nclass, input_shape=input_shape or
                                      (32, 32, 3), dropout_rate=dropout_rate,
                                      **kw)
    if model_name in ("Tiramisu", "FCDenseNet103"):
        return create_tiramisu103(nclass, input_shape, **kw)
    raise ValueError(f"unknown model {model_name!r}")


def with_aleatoric_head(spec: CNNSpec) -> CNNSpec:
    """Double the last layer's output channels for an aleatoric
    (logit + log-sigma) head (reference model_utils.py:14-60,
    NN_extended AU hypers)."""
    last = spec.layers[-1]
    new_last = replace(last, out=(last.out or spec.nclass) * 2)
    return replace(spec, layers=spec.layers[:-1] + (new_last,),
                   aleatoric=True)
