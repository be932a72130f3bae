"""``cli/repeat_runs`` and path-based subjects in the single-subject engine,
on the CPU.

* ``repeat_runs`` with ``random`` in both packages: run 0, then a second
  call to ``n_runs`` 2 that starts at run 1 from ``counter.txt``; each
  run's picks (``queries/``, the pool and training sets) equal JAX's for
  the same seed, ``counter.txt`` and ``durations.txt`` hold what JAX's
  hold.  A third run is interrupted inside its round (its directory
  holds the experiment and the method's initial state, ``counter.txt``
  still says 2) and resumed by a later call, which finishes it with the
  picks of JAX's uninterrupted run 2.
* ``PWExperiment`` on a subject read through ``config.data.img_paths`` /
  ``mask_path`` from gzip NRRD files (the ``hakim`` convention, via
  ``registry_for``) runs one core-set round with the picks, pool and
  F-measure of the same experiment on the subject held in memory.
* ``main``'s usage line and ``--device`` parsing; ``expr_handler``'s
  ``create_run``, ``print_parameters`` and ``DEMO_CAMPAIGN_OVERRIDES``
  against JAX's.

PW1 at its published widths on 7x7 patches of a 16x16x4 subject, SGD,
dropout 0, one round a run; every checkpoint is deleted once its run
ends, and the base temp is left empty.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from nnal_tpu.cli import repeat_runs as j_rr
from nnal_tpu_torch.cli import repeat_runs as t_rr
from nnal_tpu_torch.core.config import ExperimentConfig, set_parameters
from nnal_tpu_torch.cli.expr_handler import DEFAULT_PARS
from nnal_tpu_torch.data.datasets import CONVENTIONS, registry_for
from nnal_tpu_torch.data.formats import write_nrrd
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.engine import pw_experiment
from nnal_tpu_torch.engine.pw_experiment import PWExperiment

torch.set_num_threads(1)

K = 8
OVERRIDES = ("patch_shape=[7,7,1],grid_spacing=2,k=8,B=16,ntb=256,b=16,"
             "epochs=1,init_size=16,learning_rate=1e-2,optimizer_name=SGD,"
             "dropout_rate=0.0,synthetic_shape=[16,16,4]")


def _drop_npz(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".npz"):
                os.remove(os.path.join(d, f))


def _records(run_root, method="random"):
    """The text records of a run that hold its picks."""
    out = {}
    mdir = os.path.join(run_root, method)
    for f in sorted(os.listdir(os.path.join(mdir, "queries"))):
        out["queries/" + f] = open(os.path.join(mdir, "queries", f)).read()
    for f in ("curr_train_inds.txt", "curr_pool_inds.txt"):
        out[f] = open(os.path.join(mdir, f)).read()
    out["init_pool_inds.txt"] = open(
        os.path.join(run_root, "init_pool_inds.txt")).read()
    return out


class _Interrupt(Exception):
    pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    top = tmp_path_factory.mktemp("repeat_runs")
    jroot, troot = str(top / "jax"), str(top / "port")
    try:
        for n_runs in (1, 2, 3):
            j_rr.repeat_runs(jroot, ["random"], K, n_runs, OVERRIDES)
            _drop_npz(jroot)
        for n_runs in (1, 2):
            t_rr.repeat_runs(troot, ["random"], K, n_runs, OVERRIDES,
                             device="cpu")
            _drop_npz(troot)
        counter_before = open(os.path.join(troot, "counter.txt")).read()
        mp = pytest.MonkeyPatch()
        with mp.context() as c:
            def crash(self, method, nqueries):
                raise _Interrupt(method)

            c.setattr(pw_experiment.PWExperiment, "run_method", crash)
            with pytest.raises(_Interrupt):
                t_rr.repeat_runs(troot, ["random"], K, 3, OVERRIDES,
                                 device="cpu")
        interrupted = {
            "counter": open(os.path.join(troot, "counter.txt")).read(),
            "files": sorted(os.listdir(os.path.join(troot, "run_2",
                                                    "random"))),
            "queries": os.listdir(os.path.join(troot, "run_2", "random",
                                               "queries"))}
        t_rr.repeat_runs(troot, ["random"], K, 3, OVERRIDES, device="cpu")
        _drop_npz(troot)
        yield jroot, troot, counter_before, interrupted
    finally:
        shutil.rmtree(top, ignore_errors=True)


@pytest.mark.parametrize("run", [0, 1, 2])
def test_repeat_runs_picks_match_jax(runs, run):
    jroot, troot, _, _ = runs
    want = _records(os.path.join(jroot, f"run_{run}"))
    got = _records(os.path.join(troot, f"run_{run}"))
    assert got == want
    assert len(got["queries/0.txt"].split()) == K


def test_repeat_runs_counter_durations_and_resume(runs):
    jroot, troot, counter_before, interrupted = runs
    assert counter_before == "2"
    assert interrupted["counter"] == "2"
    # the crash came after add_method: the initial state is there, no
    # round is; the resumed call ran run 2's round from that state
    assert "curr_weights.npz" in interrupted["files"]
    assert interrupted["queries"] == []
    for root in (jroot, troot):
        assert open(os.path.join(root, "counter.txt")).read() == "3"
        lines = open(os.path.join(root, "durations.txt")).read().splitlines()
        assert [ln.split()[0] for ln in lines] == ["0", "1", "2"]
        assert all(float(ln.split()[1]) >= 0 for ln in lines)
    params = open(os.path.join(troot, "run_2", "parameters.txt")).read()
    assert "seed: 2" in params
    leftovers = [f for d, _, fs in os.walk(troot) for f in fs
                 if f.endswith(".npz")]
    assert leftovers == []


def test_main_usage_and_device_flag(capsys):
    assert t_rr.main([]) == 1
    assert "usage" in capsys.readouterr().out
    assert t_rr.main(["root", "random", "--device"]) == 1
    assert "--device" in capsys.readouterr().out


def test_expr_handler_front_end_matches_jax(tmp_path, capsys):
    """``DEMO_CAMPAIGN_OVERRIDES`` is JAX's; ``create_run`` makes the
    experiment ``create_expr`` makes; ``print_parameters`` prints what
    JAX's prints for the same directory."""
    from nnal_tpu.cli import expr_handler as j_cli
    from nnal_tpu_torch.cli import expr_handler as t_cli

    assert t_cli.DEMO_CAMPAIGN_OVERRIDES == j_cli.DEMO_CAMPAIGN_OVERRIDES
    try:
        expr = t_cli.create_run(str(tmp_path / "e"), OVERRIDES,
                                synthetic=True, device="cpu")
        assert isinstance(expr, PWExperiment)
        assert os.path.exists(tmp_path / "e" / "init_pool_inds.txt")
        capsys.readouterr()
        t_cli.print_parameters(str(tmp_path / "e"))
        got = capsys.readouterr().out
        j_cli.print_parameters(str(tmp_path / "e"))
        assert got == capsys.readouterr().out
        assert "patch_shape" in got
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def _path_config(pars_extra):
    pars = set_parameters(DEFAULT_PARS, OVERRIDES.replace(
        "k=8", "k=8,seed=5"))
    pars.update(pars_extra)
    return ExperimentConfig.from_pars(pars)


def test_path_based_round_equals_in_memory(tmp_path):
    """One core-set round from gzip NRRD files equals the same round on the
    subject in memory: picks, pool, training set and F-measure."""
    vols, mask = synthetic_subject(shape=(16, 16, 4), n_modalities=2,
                                   seed=5)
    conv = CONVENTIONS["hakim"]
    sub = tmp_path / "data" / "subject0"
    sub.mkdir(parents=True)
    for name, v in zip(conv.modalities, vols):
        write_nrrd(str(sub / name), v)
    write_nrrd(str(sub / conv.mask), mask)
    try:
        (s,) = registry_for("hakim", str(tmp_path / "data")).subjects
        cfg = _path_config({"img_paths": s.modality_paths,
                            "mask_path": s.mask_path})
        from_files = PWExperiment(str(tmp_path / "files"), cfg,
                                  device="cpu")
        loaded, lmask = from_files._load_subject()
        for a, b in zip(loaded, vols):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(lmask, mask)
        in_memory = PWExperiment(str(tmp_path / "memory"), _path_config({}),
                                 device="cpu")
        in_memory.attach_subject(vols, mask)
        results = []
        for expr in (from_files, in_memory):
            expr.prep_data()
            expr.add_method("core-set")
            results.append(expr.run_method("core-set", K))
            _drop_npz(expr.root_dir)
        np.testing.assert_array_equal(results[0]["perf"], results[1]["perf"])
        assert results[0]["n_queries"] == results[1]["n_queries"] == K
        files = _records(str(tmp_path / "files"), "core-set")
        assert files == _records(str(tmp_path / "memory"), "core-set")
        # a fresh engine on the same directory reads the files again
        again = PWExperiment(str(tmp_path / "files"), device="cpu")
        np.testing.assert_array_equal(again._load_subject()[0][1], vols[1])
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
