"""The tiny conv net of ``tests/test_second_order.py`` in both packages,
with the same weights (not a test file): conv1 4x3x3 -> max1 2x2 -> fc1 8
-> fc2 2, and the conversions between the JAX package's parameter pytrees
and the port's parameter dicts."""

import jax
import numpy as np
import torch

from nnal_tpu.models.cnn import init_cnn as j_init_cnn
from nnal_tpu.models.specs import CNNSpec as JSpec
from nnal_tpu.models.specs import Layer as JLayer
from nnal_tpu_torch.models.bridge import from_jax_params, to_jax_params
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.specs import CNNSpec as TSpec
from nnal_tpu_torch.models.specs import Layer as TLayer
from nnal_tpu_torch.scoring.influence import param_dict


def tiny_specs(input_shape=(6, 6, 1)):
    def spec(S, L):
        return S("tiny", (L("conv1", "conv", 4, (3, 3), (1, 1)),
                          L("max1", "pool", None, (2, 2), (2, 2)),
                          L("fc1", "fc", 8), L("fc2", "fc", 2)),
                 tuple(input_shape), 2, feature_layer=2)
    return spec(JSpec, JLayer), spec(TSpec, TLayer)


def port_model(spec, jparams) -> CNN:
    model = CNN(spec)
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return model


def tiny_pair(seed=0, input_shape=(6, 6, 1)):
    """(JAX spec, JAX params, port model, port parameter dict)."""
    jspec, tspec = tiny_specs(input_shape)
    jparams, _ = j_init_cnn(jspec, jax.random.key(seed))
    model = port_model(tspec, jparams)
    return jspec, jparams, model, param_dict(model)


def to_port(jtree, like):
    """A JAX-layout pytree as a port dict, keyed and ordered like ``like``."""
    d = from_jax_params(jax.tree_util.tree_map(np.asarray, jtree))
    return {n: d[n].to(like[n].device) for n in like}


def to_jax(tree):
    """A port dict as a JAX-layout numpy pytree."""
    return to_jax_params(tree)


def rel_err(got: dict, want: dict) -> float:
    """max |got - want| over every leaf, over max |want|."""
    num = max(float((got[n] - want[n]).abs().max()) for n in want)
    den = max(float(want[n].abs().max()) for n in want)
    return num / den


def data(n, shape=(6, 6, 1), seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + tuple(shape)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    return x, y, torch.from_numpy(x), torch.from_numpy(y)
