"""The port's examples, continued (``tests/test_torch_examples.py`` has
the first three), at ``--tiny`` on the host:

* ``serving``: F (float and int8) and the int8 / float agreement in
  [0, 1]; the untrained FC-DenseNet's ``posteriors`` and
  ``MC-posteriors`` have the shape JAX's ``FCNInference`` gives (the
  port draws its own seed-7 init, so only shapes are compared;
  ``jax.eval_shape``, nothing of JAX is run);
* ``multi_subject_al``: ``n_queries``, two rounds, finite F in [0, 1] and
  a 2 x k round-0 query matrix;
* ``dense_model_al`` with ``--mt``: both methods' two rounds;
* every example's ``python -m`` entry asks for the card by default and,
  without CUDA, fails naming ``device="cpu"``.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnal_tpu.models.cnn import apply_cnn as j_apply
from nnal_tpu.models.cnn import init_cnn as j_init_cnn
from nnal_tpu.models.specs import create_tiramisu103 as j_tiramisu
from nnal_tpu_torch.core.journal import load_inds
from nnal_tpu_torch.evaluation import inference as t_inf
from nnal_tpu_torch.examples import (dense_model_al, multi_subject_al,
                                     serving)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("patchwise_al", "multi_subject_al", "classification_al",
            "serving", "dense_model_al", "multichip_campaign")


@pytest.fixture
def tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_serving_example(monkeypatch):
    shapes = {}
    segment = t_inf.FCNInference.segment

    def recording(self, model, vol_slices, op="prediction", **kw):
        out = segment(self, model, vol_slices, op, **kw)
        shapes[op] = (vol_slices.shape, out.shape)
        return out

    monkeypatch.setattr(t_inf.FCNInference, "segment", recording)
    res = serving.main(tiny=True, device="cpu")
    assert set(res) == {"f_float", "f_int8", "agreement"}
    for key in res:
        assert 0.0 <= res[key] <= 1.0, key
    assert set(shapes) == {"posteriors", "MC-posteriors"}
    x_shape = shapes["posteriors"][0]
    assert x_shape == (6, 24, 24, 2)
    spec = j_tiramisu(2, x_shape[1:], growth=2, depths=(2, 2))
    params = jax.eval_shape(lambda k: j_init_cnn(spec, k)[0],
                            jax.random.key(7))
    want = jax.eval_shape(lambda p, x: j_apply(spec, p, x).posteriors,
                          params, jax.ShapeDtypeStruct(x_shape, jnp.float32))
    for op in shapes:
        assert shapes[op][1] == want.shape, op


def test_multi_subject_example(tmp_path):
    res = multi_subject_al.main(str(tmp_path), "entropy", nqueries=6,
                                tiny=True, device="cpu")
    assert res["n_queries"] == 6
    perf = np.atleast_1d(res["perf"])
    assert len(perf) == 2 and np.isfinite(perf).all()
    assert ((perf >= 0) & (perf <= 1)).all()
    q0 = load_inds(str(tmp_path / "entropy" / "queries" / "0.txt"),
                   matrix=True)
    assert q0.shape == (2, 3) and set(q0[1].tolist()) <= {0, 1}


def test_dense_model_example_with_mt(tmp_path):
    curves = dense_model_al.main(str(tmp_path), ("entropy", "BADGE"),
                                 nqueries=8, tiny=True, mt=True,
                                 device="cpu")
    assert set(curves) == {"entropy", "BADGE"}
    for curve in curves.values():
        assert len(curve) == 2
        assert np.isfinite(curve).all()
    pars = (tmp_path / "entropy" / "parameters.txt").read_text()
    assert "consistency_off_labels: 48" in pars


def test_examples_run_on_the_card_by_default(tmp_path):
    # one interpreter runs every example's ``__main__`` in turn, as
    # ``python -m`` would, with no CUDA device visible
    code = (
        "import runpy, sys\n"
        f"for name in {EXAMPLES!r}:\n"
        f"    sys.argv = [name, {str(tmp_path)!r} + '/' + name, '--tiny']\n"
        "    if name == 'serving':\n"
        "        sys.argv = [name, '--tiny']\n"
        "    try:\n"
        "        runpy.run_module('nnal_tpu_torch.examples.' + name,\n"
        "                         run_name='__main__')\n"
        "    except RuntimeError as e:\n"
        "        print(name, 'raised:', e)\n"
        "    else:\n"
        "        print(name, 'ran')\n")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == len(EXAMPLES), r.stdout
    for name, line in zip(EXAMPLES, lines):
        assert line.startswith(f"{name} raised:"), line
        assert 'device="cpu"' in line, line
    for name in EXAMPLES:
        assert not os.path.exists(tmp_path / name / "parameters.txt")
