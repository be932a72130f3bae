"""Three repairs of the port (CPU):

* a strategy only the JAX package has raises ``NotImplementedError``
  naming its ROADMAP item, in ``cnn_query`` and in ``do_expr`` before any
  method directory is written (a stand-in name: since items 6-7,
  ``influence``, ``ps-random`` and ``SuPix`` run, and the list is empty);
  a name neither package has still raises ``ValueError``;
* the port resumes an experiment whose ``state.json`` the JAX package
  wrote: JAX runs ``random`` for 2 rounds, the port runs round 3 and picks
  what a JAX run continued to 3 rounds picks (host streams only);
* ``synthetic_shape`` / ``synthetic_blobs`` persist in ``parameters.txt``:
  a reloaded port directory regenerates the same subject, and the JAX
  package's loader opens the directory and reads them.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from nnal_tpu.cli.expr_handler import create_expr as j_create_expr
from nnal_tpu.cli.expr_handler import do_expr as j_do_expr
from nnal_tpu.core.rng import RngStream as JRng
from nnal_tpu.scoring import strategies as jstrat
from nnal_tpu_torch.cli import expr_handler as t_cli
from nnal_tpu_torch.core.rng import RngStream
from nnal_tpu_torch.scoring import strategies as tstrat
from test_torch_parallel_engine import link_npz

torch.set_num_threads(1)

BASE = ("patch_shape=[9,9,1],grid_spacing=2,k=6,ntb=512,b=16,epochs=1,"
        "init_size=12,learning_rate=1e-3,optimizer_name=Adam")


@pytest.fixture
def tmp_path(tmp_path):
    """Drop the checkpoints (tens of MB each) as soon as the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_reference_only_strategy_raises_up_front(tmp_path, monkeypatch):
    """The mechanism, with a stand-in name: a strategy listed in
    ``REFERENCE_ONLY`` raises naming its item, in ``cnn_query`` and in
    ``do_expr`` before any directory is written."""
    monkeypatch.setitem(tstrat.REFERENCE_ONLY, "not-yet-ported", 99)
    root = tmp_path / "e"
    with pytest.raises(NotImplementedError, match="item 99"):
        t_cli.do_expr(str(root), "not-yet-ported", 10, BASE, synthetic=True,
                      device="cpu")
    assert not root.exists()
    ctx = tstrat.QueryContext(spec=None, params=None, evaluator=None,
                              pool_inds=np.arange(3), k=1,
                              rng=np.random.default_rng(0))
    with pytest.raises(NotImplementedError, match="not-yet-ported"):
        tstrat.cnn_query(ctx, "not-yet-ported")


@pytest.mark.parametrize("method,extra", [
    ("influence", ",influence_mode=arnoldi,arnoldi_rank=2"),
    ("ps-random", ""), ("SuPix", "")])
def test_formerly_reference_only_strategy_runs_a_round(tmp_path, method,
                                                       extra):
    """The three strategies the port lacked until ROADMAP items 6-7 run
    one ``do_expr`` round on the host."""
    res = t_cli.do_expr(str(tmp_path / "e"), method, 6, BASE + extra,
                        synthetic=True, device="cpu")
    assert len(res["perf"]) == 1 and np.isfinite(res["perf"]).all()
    assert res["n_queries"] == 6 if method != "SuPix" else \
        res["n_queries"] >= 6
    assert len(res["train_inds"]) == 12 + res["n_queries"]


def test_every_jax_strategy_is_ported_or_listed():
    port, ref_only = set(tstrat._STRATEGIES), set(tstrat.REFERENCE_ONLY)
    assert not port & ref_only
    assert port | ref_only == set(jstrat._STRATEGIES)
    assert not ref_only and len(port) == 15


def test_unknown_method_raises_before_writing(tmp_path):
    root = tmp_path / "e"
    with pytest.raises(ValueError, match="unknown query method"):
        t_cli.do_expr(str(root), "no-such-method", 10, BASE,
                      synthetic=True, device="cpu")
    assert not root.exists()


def test_rng_restores_a_jax_state():
    """The host generator resumes exactly; the device generator gets a
    process-stable seed from the key words."""
    j = JRng(11)
    j.next()
    j.host.integers(0, 100, size=5)
    state = json.loads(json.dumps(j.state()))      # as state.json holds it
    assert isinstance(state["key"], list)
    a, b = RngStream(0), RngStream(3)
    a.restore(state)
    b.restore(state)
    want = j.host.integers(0, 10 ** 6, size=20)
    np.testing.assert_array_equal(a.host.integers(0, 10 ** 6, size=20),
                                  want)
    assert a.next() == b.next()
    # the port's own record still round-trips
    c = RngStream(5)
    c.next()
    rec = json.loads(json.dumps(c.state()))
    d = RngStream(0)
    d.restore(rec)
    assert d.next() == c.next()


def test_port_resumes_a_jax_random_campaign(tmp_path):
    """Default 36x36x10 synthetic subject in every run (the JAX package
    does not persist ``synthetic_shape``)."""
    jdir = str(tmp_path / "jax")
    j_do_expr(jdir, "random", 12, BASE, synthetic=True)
    jcont, tdir = str(tmp_path / "jax_cont"), str(tmp_path / "port")
    shutil.copytree(jdir, jcont, copy_function=link_npz)
    shutil.copytree(jdir, tdir, copy_function=link_npz)
    shutil.rmtree(jdir)
    with open(os.path.join(tdir, "random", "state.json")) as f:
        assert isinstance(json.load(f)["rng"]["key"], list)
    j_do_expr(jcont, "random", 18, synthetic=True)
    res = t_cli.do_expr(tdir, "random", 18, synthetic=True, device="cpu")
    assert res["n_queries"] == 18 and len(res["perf"]) == 3
    picks = [np.loadtxt(os.path.join(d, "random", "queries", "2.txt"),
                        dtype=np.int64) for d in (jcont, tdir)]
    assert len(picks[1]) == 6
    np.testing.assert_array_equal(picks[1], picks[0])
    # the port writes its own record, which the JAX package cannot read
    with open(os.path.join(tdir, "random", "state.json")) as f:
        port_state = json.load(f)["rng"]
    assert isinstance(port_state["key"], str)
    with pytest.raises(Exception):
        JRng(0).restore(port_state)


def test_synthetic_shape_persists(tmp_path):
    root = str(tmp_path / "e")
    over = BASE + ",synthetic_shape=[20,20,6],synthetic_blobs=5"
    first = t_cli.create_expr(root, over, synthetic=True, device="cpu")
    with open(os.path.join(root, "parameters.txt")) as f:
        pars = yaml.safe_load(f)
    assert pars["synthetic_shape"] == [20, 20, 6]
    assert pars["synthetic_blobs"] == 5
    again = t_cli.create_expr(root, synthetic=True, device="cpu")
    assert again._vols[0].shape == (20, 20, 6)
    for a, b in zip(first._vols + [first._mask],
                    again._vols + [again._mask]):
        np.testing.assert_array_equal(a, b)
    # the JAX package opens it, keeps the keys and builds the same subject
    jexpr = j_create_expr(root, synthetic=True)
    assert list(jexpr.config.synthetic_shape) == [20, 20, 6]
    assert jexpr.config.synthetic_blobs == 5
    np.testing.assert_array_equal(jexpr._vols[0], first._vols[0])
    np.testing.assert_array_equal(jexpr._mask, first._mask)
