"""The process-group paths (``parallel/sharding.py``,
``parallel/multihost.py``, ``parallel/dryrun.py``) on the CPU with
``gloo``.

* The TP plan and the parameter template equal JAX's
  ``param_partition_specs`` / ``spec_params_template`` (fc1 split on its
  output features, fc2 on its input features, all else replicated).
* A 2-process DP step (mesh 2 x 1) and a 2-process TP step (mesh 1 x 2) of
  PW1 (dropout 0, SGD): parameters and loss within 1e-5 of JAX's
  ``make_sharded_train_step`` on the conftest's CPU mesh of the same
  shape.
* In one process, a world-size-1 group: ``init_distributed`` is
  idempotent, the sharded step with dropout equals a plain step on the
  same masks BIT FOR BIT (the check ``chip_smoke.py`` repeats on the
  card with ``nccl``), and ``sharded_pool_topk`` equals a plain top-k.
* ``process_local_pool_slice`` equals JAX's for 1 and 3 processes, and
  ``make_multihost_mesh`` keeps the model axis on a host.
* ``dryrun_multichip(2)`` passes: DP / TP steps within 1e-5 of one
  process, the pool top-k, the AL round's selections, the fi PMF draws,
  the sharded serving and the sharded evaluator bit-identical to one
  process.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from nnal_tpu.models.cnn import init_cnn as j_init_cnn
from nnal_tpu.models.optim import make_optimizer as j_make_optimizer
from nnal_tpu.models.specs import create_pw1 as j_create_pw1
from nnal_tpu.parallel import multihost as jmh
from nnal_tpu.parallel import sharding as jsh
from nnal_tpu.parallel.mesh import make_mesh as j_make_mesh
from nnal_tpu_torch.core import rng as core_rng
from nnal_tpu_torch.models.bridge import from_jax_params
from nnal_tpu_torch.models.cnn import init_cnn
from nnal_tpu_torch.models.specs import create_pw1
from nnal_tpu_torch.models.train import TrainState
from nnal_tpu_torch.parallel import multihost as tmh
from nnal_tpu_torch.parallel import sharding as tsh
from nnal_tpu_torch.parallel.dryrun import (
    dryrun_multichip,
    free_port,
    sharded_step_in_processes,
)
from nnal_tpu_torch.parallel.mesh import stable_topk
from torch_jax_dense import port_model

torch.set_num_threads(1)

PS = (9, 9, 1)


@pytest.fixture(scope="module")
def pair():
    jspec = j_create_pw1(2, 0.0, PS)
    params, _ = j_init_cnn(jspec, jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    return jspec, params, port_model(create_pw1(2, 0.0, PS), params)


def test_tp_plan_and_template_match_jax(pair):
    jspec, params, model = pair
    jspecs = jsh.param_partition_specs(params)
    tspecs = tsh.param_partition_specs(model)
    P = jax.sharding.PartitionSpec
    # JAX's W is (in, out), torch's weight (out, in)
    want = {P(None, "model"): 0, P("model", None): 1, P("model"): 0}
    for layer, d in jspecs.items():
        for k, s in d.items():
            name = f"{layer}.{'weight' if k == 'W' else 'bias'}"
            assert tspecs[name] == want.get(s), (name, s)
    assert set(tsh.param_partition_specs(model, False).values()) == {None}
    tmpl = tsh.spec_params_template(model.spec)
    jt = jsh.spec_params_template(jspec)
    for layer, d in jt.items():
        assert int(np.prod(tmpl[f"{layer}.weight"])) == int(
            np.prod(d["W"].shape))
        assert tuple(tmpl[f"{layer}.bias"]) == tuple(d["b"].shape)


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_two_process_step_matches_jax(pair, model_parallel):
    jspec, params, model = pair
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8,) + PS).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[np.arange(8) % 2]
    full, loss = sharded_step_in_processes(
        2, model_parallel, model.spec, model.state_dict(), x, y)
    mesh = j_make_mesh(2, model_parallel=model_parallel)
    tx = j_make_optimizer("SGD", 1e-2)
    jp = jsh.shard_params(jax.tree_util.tree_map(jnp.asarray, params), mesh)
    new, _, jloss = jsh.make_sharded_train_step(jspec, mesh, tx)(
        jp, tx.init(jp), jnp.asarray(x), jnp.asarray(y), jax.random.key(2))
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, new))
    for k, v in want.items():
        np.testing.assert_allclose(full[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))


def test_world_of_one_step_is_the_plain_step():
    tmh.init_distributed(f"localhost:{free_port()}", 1, 0, device="cpu")
    try:
        tmh.init_distributed("localhost:1", 1, 0, device="cpu")  # a no-op
        mesh = tmh.make_multihost_mesh(1, device="cpu")
        assert mesh.shape == {"data": 1, "model": 1}
        base = init_cnn(create_pw1(2, 0.5, PS), 4, device="cpu")
        rng = np.random.default_rng(5)
        x = torch.as_tensor(rng.normal(size=(16,) + PS).astype(np.float32))
        y = torch.nn.functional.one_hot(torch.arange(16) % 2, 2).float()
        local = tsh.shard_params(base, mesh)
        state = TrainState(local, torch.optim.Adam(local.parameters(),
                                                   lr=1e-3))
        loss = tsh.make_sharded_train_step(mesh)(state, x, y, 9)
        ref = copy.deepcopy(base)
        opt = torch.optim.Adam(ref.parameters(), lr=1e-3)
        logits = ref(x, train=True,
                     generator=core_rng.key_stream(9, x.device)).logits
        ref_loss = (-(y * torch.log_softmax(logits, -1)).sum(-1)).sum() / 16
        ref_loss.backward()
        opt.step()
        assert float(loss) == float(ref_loss.detach())
        for (n, a), (_, b) in zip(local.named_parameters(),
                                  ref.named_parameters()):
            assert torch.equal(a, b), n
        scores = torch.as_tensor(rng.normal(size=32).astype(np.float32))
        scores[5] = scores[7] = scores.max()
        vals, idx = tsh.sharded_pool_topk(mesh, lambda m, s: s, 4)(None,
                                                                   scores)
        r_vals, r_idx = stable_topk(scores, 4)
        assert torch.equal(vals, r_vals) and idx.tolist() == r_idx.tolist()
        assert idx.tolist()[:2] == [5, 7]
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("nproc", [1, 3])
def test_process_local_pool_slice_and_mesh_rules(monkeypatch, nproc):
    for pid in range(nproc):
        monkeypatch.setattr(tmh, "_world", lambda: (pid, nproc))
        monkeypatch.setattr(jax, "process_index", lambda: pid)
        monkeypatch.setattr(jax, "process_count", lambda: nproc)
        assert tmh.process_local_pool_slice(103) == \
            jmh.process_local_pool_slice(103)
    monkeypatch.setattr(tmh, "_world", lambda: (0, 4))
    m = tmh.make_multihost_mesh(2, processes_per_host=2, device="cpu")
    assert m.shape == {"data": 2, "model": 2}
    assert m.ranks.tolist() == [[0, 1], [2, 3]] and m.coords(3) == (1, 1)
    with pytest.raises(ValueError, match="span hosts"):
        tmh.make_multihost_mesh(4, processes_per_host=2, device="cpu")


def test_dryrun_multichip_two_processes():
    report = dryrun_multichip(2)
    assert report["topk"] == report["al_round"] == "bit-identical"
    assert report["step_tp2_max_abs_err"] <= 1e-5
    assert report["step_dp2_max_abs_err"] <= 1e-5
