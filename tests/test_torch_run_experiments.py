"""``nnal_tpu_torch/cli/run_experiments.sh``, the chunked campaign
driver, on the host (``cpu`` as its sixth argument):

* ``random`` in two chunks of 5 queries, one process each (the second
  resumes from the journal), writes the same ``queries/*.txt`` and
  ``perf_evals.txt`` as one run of 10;
* without ``cpu`` it runs on the card, so without CUDA its first chunk
  fails, naming ``device="cpu"``; any other sixth argument is refused.

Tiny shapes; the campaign directories are deleted at the end.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "nnal_tpu_torch", "cli", "run_experiments.sh")
OVERRIDES = ("patch_shape=[7,7,1],grid_spacing=2,k=5,B=16,b=16,epochs=1,"
             "init_size=8,ntb=256,synthetic_shape=[16,16,4]")


@pytest.fixture
def tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _run(*args, env=None):
    env = {**os.environ,
           "PATH": os.path.dirname(sys.executable) + os.pathsep
           + os.environ.get("PATH", ""),
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           **(env or {})}
    return subprocess.run(["bash", SCRIPT, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def _journal(root):
    qdir = os.path.join(root, "random", "queries")
    out = {f: np.loadtxt(os.path.join(qdir, f), dtype=np.int64)
           for f in sorted(os.listdir(qdir))}
    out["perf"] = np.loadtxt(os.path.join(root, "random", "perf_evals.txt"))
    return out


def test_two_chunks_equal_one_run(tmp_path):
    chunked, whole = str(tmp_path / "chunked"), str(tmp_path / "whole")
    r = _run(chunked, "random", "10", "5", OVERRIDES, "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.count("method=random") == 2
    r = _run(whole, "random", "10", "10", OVERRIDES, "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    got, want = _journal(chunked), _journal(whole)
    assert sorted(got) == sorted(want) == ["0.txt", "1.txt", "perf"]
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert len(np.unique(np.concatenate([got["0.txt"], got["1.txt"]]))) \
        == 10


def test_card_by_default_and_bad_device(tmp_path):
    r = _run(str(tmp_path / "e"), "random", "5", "5", OVERRIDES,
             env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert 'device="cpu"' in r.stderr
    r = _run(str(tmp_path / "f"), "random", "5", "5", OVERRIDES, "gpu")
    assert r.returncode == 2 and "'gpu'" in r.stderr
    assert not os.path.exists(tmp_path / "f")
