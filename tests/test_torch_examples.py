"""The port's examples (``nnal_tpu_torch/examples/``) at ``--tiny`` on
the host, held to the contract ``tests/test_examples.py`` asserts of the
JAX package's scripts (method keys, round counts, finite curves, F and
accuracy in [0, 1]); the JAX scripts themselves are not run here.

* ``patchwise_al``: one method's two rounds; the experiment that
  ``cli/expr_handler.create_expr`` + ``prep_data`` set up for it (the
  ``--tiny`` overrides and the documented protocol,
  ``DEMO_CAMPAIGN_OVERRIDES``) writes the same initial pool, test grid,
  labels and statistics as the JAX package's on the same overrides (host
  streams only; nothing is trained).
* ``multichip_campaign`` at ``data_parallel`` 8 over ``cpu`` x 8: every
  round picks what ``data_parallel`` 1 picks.
* ``classification_al``: both methods' curves.

``tests/test_torch_examples_more.py`` holds the other three.  Each
campaign directory is deleted at the end.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from nnal_tpu.cli import expr_handler as j_cli
from nnal_tpu_torch.cli import expr_handler as t_cli
from nnal_tpu_torch.examples import (classification_al, multichip_campaign,
                                     patchwise_al)

torch.set_num_threads(1)

PREP_FILES = ("init_pool_inds.txt", "init_pool_labels.txt", "test_inds.txt",
              "test_labels.txt", "train_stats.txt")


@pytest.fixture
def tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_patchwise_example(tmp_path):
    curves = patchwise_al.main(str(tmp_path), ("entropy",), nqueries=10,
                               tiny=True, device="cpu")
    assert set(curves) == {"entropy"}
    assert len(curves["entropy"]) == 2
    assert np.isfinite(curves["entropy"]).all()
    assert ((curves["entropy"] >= 0) & (curves["entropy"] <= 1)).all()
    q = [np.loadtxt(tmp_path / "entropy" / "entropy" / "queries" / f"{r}.txt")
         for r in range(2)]
    assert [len(v) for v in q] == [5, 5]


@pytest.mark.parametrize("protocol", ["tiny", "demo"])
def test_patchwise_setup_matches_jax(tmp_path, protocol):
    overrides = (patchwise_al.TINY_OVERRIDES if protocol == "tiny"
                 else t_cli.DEMO_CAMPAIGN_OVERRIDES)
    assert t_cli.DEMO_CAMPAIGN_OVERRIDES == j_cli.DEMO_CAMPAIGN_OVERRIDES
    texpr = t_cli.create_expr(str(tmp_path / "t"), overrides, synthetic=True,
                              device="cpu")
    j_cli.create_expr(str(tmp_path / "j"), overrides, synthetic=True)
    for name in PREP_FILES:
        got = np.loadtxt(tmp_path / "t" / name)
        want = np.loadtxt(tmp_path / "j" / name)
        assert got.shape == want.shape and got.size > 0, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    shape = tuple(texpr.config.synthetic_shape)
    assert shape == ((24, 24, 8) if protocol == "tiny" else (40, 40, 12))


def test_multichip_example_dp8_equals_dp1(tmp_path):
    multichip_campaign.main(str(tmp_path), tiny=True, device="cpu")
    rounds = sorted(os.listdir(tmp_path / "dp8" / "entropy" / "queries"))
    assert rounds == ["0.txt", "1.txt"]
    for r in rounds:
        q8 = np.loadtxt(tmp_path / "dp8" / "entropy" / "queries" / r)
        q1 = np.loadtxt(tmp_path / "dp1" / "entropy" / "queries" / r)
        assert len(q8) == 5
        np.testing.assert_array_equal(q8, q1)
    for tag, dp in (("dp8", 8), ("dp1", 1)):
        pars = (tmp_path / tag / "parameters.txt").read_text()
        assert f"data_parallel: {dp}" in pars


def test_classification_example(tmp_path):
    summary = classification_al.main(str(tmp_path), ("entropy", "random"),
                                     nqueries=10, tiny=True, device="cpu")
    assert set(summary) == {"entropy", "random"}
    for curve in summary.values():
        curve = np.atleast_1d(curve)
        assert len(curve) == 2
        assert np.isfinite(curve).all()
        assert ((curve >= 0) & (curve <= 1)).all()
