"""Feed JAX's own threefry draws through the port's draw functions.

Every stochastic pass of the port takes its generator from
``core.rng.key_generator(key, tag, device)`` (child keys from
``core.rng.fold_key``) and draws through one module-level function per
kind of draw.  :func:`inject` replaces those with JAX's: a "generator"
becomes a :class:`KeyGen` holding ``fold_in(key, tag)``, and each draw
function returns what the JAX package draws from that key, so the port
and the JAX package can be held to the same masks, noise and samples
(Philox and threefry streams cannot be matched otherwise).  Pass a JAX
key wherever the port takes an integer key."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.flatten_util import ravel_pytree

from nnal_tpu_torch.core import rng as core_rng
from nnal_tpu_torch.models import cnn as t_cnn
from nnal_tpu_torch.models import losses as t_losses
from nnal_tpu_torch.models import perturb as t_perturb
from nnal_tpu_torch.models.bridge import from_jax_params, to_jax_params
from nnal_tpu_torch.scoring import batchbald as t_bb
from nnal_tpu_torch.scoring import hessian as t_hess
from nnal_tpu_torch.scoring import representative as t_rep


class KeyGen:
    """Stands in for a ``torch.Generator``: carries a JAX key."""

    def __init__(self, key):
        self.key = key


def to_torch(a, device="cpu", dtype=None):
    """A JAX array as a torch tensor (bf16 through f32, exactly)."""
    arr = np.asarray(a)
    if arr.dtype == jnp.bfloat16:
        return torch.from_numpy(arr.astype(np.float32)).to(
            device, torch.bfloat16)
    t = torch.from_numpy(np.array(arr))
    return t.to(device) if dtype is None else t.to(device, dtype)


def _jdtype(dtype):
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]


def lanczos_start(params, key, device):
    """JAX's Lanczos start (one ``normal(key)`` over ``ravel_pytree`` of
    the params: sorted layer names, W before b, JAX layouts), carried into
    the port's flat order and layouts."""
    flat, unravel = ravel_pytree(to_jax_params(params))
    tree = unravel(jax.random.normal(key, flat.shape, jnp.float32))
    d = from_jax_params(jax.tree_util.tree_map(np.asarray, tree))
    return torch.cat([d[n].reshape(-1) for n in params]).to(device)


def inject(monkeypatch):
    fold = jax.random.fold_in
    monkeypatch.setattr(core_rng, "fold_key", lambda key, tag: fold(key, tag))
    monkeypatch.setattr(core_rng, "int_key", lambda n: jax.random.key(n))
    monkeypatch.setattr(core_rng, "key_stream",
                        lambda key, device: KeyGen(key))
    monkeypatch.setattr(core_rng, "key_generator",
                        lambda key, tag, device: KeyGen(fold(key, tag)))
    monkeypatch.setattr(
        t_cnn, "_dropout_uniform",
        lambda shape, gen, device, i: to_torch(jax.random.uniform(
            fold(gen.key, i), tuple(shape), jnp.float32), device))
    monkeypatch.setattr(
        t_losses, "_aleatoric_normal",
        lambda shape, gen, device: to_torch(jnp.stack([
            jax.random.normal(k, tuple(shape[1:]), jnp.float32)
            for k in jax.random.split(gen.key, shape[0])]), device))
    monkeypatch.setattr(
        t_perturb, "_gaussian_noise",
        lambda shape, dtype, gen, device: to_torch(jax.random.normal(
            gen.key, tuple(shape), _jdtype(dtype)), device))
    monkeypatch.setattr(
        t_bb, "_t_assign",
        lambda M, T, gen, device, tag=0: to_torch(jax.random.randint(
            fold(gen.key, tag), (M,), 0, T), device, torch.int64))
    monkeypatch.setattr(
        t_bb, "_uniform",
        lambda M, gen, device, tag: to_torch(jax.random.uniform(
            fold(gen.key, tag), (M,)), device))
    monkeypatch.setattr(
        core_rng, "gumbel",
        lambda shape, gen, device, tag: to_torch(jax.random.gumbel(
            fold(gen.key, tag), tuple(shape), jnp.float32), device))
    monkeypatch.setattr(t_hess, "_lanczos_start", lanczos_start)
    monkeypatch.setattr(
        t_rep, "_first_index",
        lambda n, gen, device: to_torch(jax.random.randint(
            gen.key, (), 0, n), device, torch.int64))
