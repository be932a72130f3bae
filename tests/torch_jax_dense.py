"""Small dense (fcn) models in both packages with the same weights (not a
test file): the FC-DenseNet-103 spec of the JAX package's dense tests cut
to growth 4 and depths [2, 2], its parameters and BN state moved off
their init values (so gamma, beta and the running statistics matter), and
the conversions of the BN state."""

import jax
import numpy as np
import torch

from nnal_tpu.models.cnn import init_cnn as j_init_cnn
from nnal_tpu.models.specs import create_model as j_create_model
from nnal_tpu_torch.models.bridge import bn_state_to_port, from_jax_params
from nnal_tpu_torch.models.cnn import CNN
from nnal_tpu_torch.models.specs import create_model as t_create_model

TINY = dict(growth=4, depths=(2, 2))


def dense_specs(H=24, W=None, nmod=2, nclass=2, dropout_rate=0.2,
                name="Tiramisu", **kw):
    kw = {**(TINY if name == "Tiramisu" else {}), **kw}
    args = dict(nclass=nclass, input_shape=(H, W or H, nmod),
                dropout_rate=dropout_rate, **kw)
    return j_create_model(name, **args), t_create_model(name, **args)


def jax_weights(jspec, seed=0, jitter=0.1):
    """JAX params and BN state, each leaf moved by ``jitter`` N(0, 1)
    (the running variance by its magnitude, so it stays positive)."""
    params, state = j_init_cnn(jspec, jax.random.key(seed))
    rng = np.random.default_rng(seed + 100)

    def move(a, positive=False):
        a = np.asarray(a, np.float32)
        d = jitter * rng.normal(size=a.shape).astype(np.float32)
        return (a + np.abs(d)) if positive else (a + d)

    params = {l: {k: move(v) for k, v in p.items()} for l, p in params.items()}
    state = {l: {"mean": move(s["mean"]), "var": move(s["var"], True)}
             for l, s in state.items()}
    return params, state


def port_model(tspec, params, device="cpu") -> CNN:
    model = CNN(tspec)
    model.load_state_dict(from_jax_params(params))
    return model.to(device)


def dense_pair(seed=0, **kw):
    """(JAX spec, JAX params, JAX BN state, port model, port BN state)."""
    jspec, tspec = dense_specs(**kw)
    params, state = jax_weights(jspec, seed)
    return (jspec, params, state, port_model(tspec, params),
            bn_state_to_port(state, "cpu"))


def slices(n, H=24, W=None, nmod=2, seed=1):
    x = np.random.default_rng(seed).normal(
        size=(n, H, W or H, nmod)).astype(np.float32)
    return x, torch.from_numpy(x)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)
