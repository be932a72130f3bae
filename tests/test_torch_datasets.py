"""The port's subjects, registries and dataset conventions
(``data/io.Subject`` / ``SubjectRegistry``, ``data/datasets``) against
the JAX package's, on the CPU.

``registry_for`` over every convention of ``CONVENTIONS``, on one root
that holds complete subjects, a subject without its mask, an incomplete
one and a stray file: the same subject names, paths and masks in the same
order as JAX's, and ``Subject.load`` bit-equal.  ``from_lists`` the same
way, and ``write_synthetic_dataset``'s files and registry bit-equal to
JAX's.  The multi-subject engine's route for file subjects (no engine
calls the registry; ``Subject.load()``'s volumes go to
``attach_subjects``): one ``random`` round over NIfTI subjects read
through ``registry_for("iseg2017")`` picks what the same round over the
volumes in memory picks, and what the JAX engine picks over its own
registry's load (PW1 on 7x7 patches, SGD; checkpoints deleted).  Tiny
volumes; each test deletes what it wrote.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from nnal_tpu.core.config import ExperimentConfig as JConfig
from nnal_tpu.data import datasets as jds
from nnal_tpu.data import io as jio
from nnal_tpu.engine.multi_experiment import MultiImgExperiment as JMulti
from nnal_tpu_torch.core.config import ExperimentConfig
from nnal_tpu_torch.data import datasets as tds
from nnal_tpu_torch.data import io as tio
from nnal_tpu_torch.data.formats import write_nifti, write_nrrd
from nnal_tpu_torch.engine.multi_experiment import MultiImgExperiment

torch.set_num_threads(1)


@pytest.fixture
def tmp(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _write(path, arr):
    if path.endswith(".nrrd"):
        write_nrrd(path, arr)
    else:
        write_nifti(path, arr)


def _subjects(reg):
    return [(s.name, s.modality_paths, s.mask_path) for s in reg.subjects]


def _same_loads(treg, jreg):
    for ts, js in zip(treg.subjects, jreg.subjects):
        (tv, tm), (jv, jm) = ts.load(), js.load()
        assert len(tv) == len(jv)
        for a, b in zip(tv, jv):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        if jm is None:
            assert tm is None
        else:
            np.testing.assert_array_equal(tm, jm)


def test_conventions_are_the_jax_packages():
    assert list(tds.CONVENTIONS) == list(jds.CONVENTIONS)
    for name, c in tds.CONVENTIONS.items():
        j = jds.CONVENTIONS[name]
        assert (c.name, c.modalities, c.mask, c.notes) == (
            j.name, j.modalities, j.mask, j.notes)


@pytest.mark.parametrize("dataset", sorted(jds.CONVENTIONS))
def test_registry_for_matches_jax(tmp, dataset):
    conv = tds.CONVENTIONS[dataset]
    rng = np.random.default_rng(len(dataset))
    for sub in ("s2", "s0", "s1", "s3"):
        d = tmp / sub
        d.mkdir()
        mods = conv.modalities if sub != "s3" else conv.modalities[:-1]
        for m in mods:
            _write(str(d / m), rng.normal(size=(4, 3, 2)).astype(np.float32))
        if sub != "s1":     # s1 has no mask; s3 lacks its last modality
            _write(str(d / conv.mask),
                   (rng.uniform(size=(4, 3, 2)) > 0.5).astype(np.uint8))
    (tmp / "notes.txt").write_text("not a subject")
    treg = tds.registry_for(dataset, str(tmp))
    jreg = jds.registry_for(dataset, str(tmp))
    assert _subjects(treg) == _subjects(jreg)
    assert [s.name for s in treg.subjects] == ["s0", "s1", "s2"]
    assert treg.subjects[1].mask_path is None
    _same_loads(treg, jreg)
    with pytest.raises(KeyError):
        tds.registry_for("no-such-dataset", str(tmp))


def test_from_lists_matches_jax(tmp):
    paths, masks = [], []
    for i, ext in enumerate((".nrrd", ".nii", ".nii.gz")):
        mods = [str(tmp / f"s{i}_m{j}{ext}") for j in range(2)]
        for j, p in enumerate(mods):
            _write(p, np.full((3, 3, 2), 10 * i + j, np.int16))
        mk = str(tmp / f"s{i}_mask{ext}")
        _write(mk, np.eye(3, dtype=np.uint8)[..., None].repeat(2, -1))
        paths.append(mods)
        masks.append(mk)
    treg = tio.SubjectRegistry.from_lists(paths, masks)
    jreg = jio.SubjectRegistry.from_lists(paths, masks)
    assert _subjects(treg) == _subjects(jreg)
    assert [s.name for s in treg.subjects] == ["0", "1", "2"]
    _same_loads(treg, jreg)


def test_write_synthetic_dataset_matches_jax(tmp):
    kw = dict(shape=(10, 9, 4), n_modalities=2, n_blobs=2, nan_margin=1)
    treg = tio.write_synthetic_dataset(str(tmp / "t"), 2, **kw)
    jreg = jio.write_synthetic_dataset(str(tmp / "j"), 2, **kw)
    rel = [[(s.name, [os.path.relpath(p, r) for p in s.modality_paths],
             os.path.relpath(s.mask_path, r)) for s in reg.subjects]
           for reg, r in ((treg, tmp / "t"), (jreg, tmp / "j"))]
    assert rel[0] == rel[1]
    _same_loads(treg, jreg)
    vols, mask = tio.synthetic_subject(seed=1, **kw)
    (tv, tm) = treg.subjects[1].load()
    for a, b in zip(tv, vols):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tm, mask)


MULTI = {"model_name": "PW", "patch_shape": (7, 7, 1), "grid_spacing": 2,
         "k": 8, "B": 16, "b": 16, "epochs": 1, "learning_rate": 1e-2,
         "optimizer_name": "SGD", "dropout_rate": 0.0, "ntb": 256,
         "seed": 3, "init_size": 8}


def _multi_round(root, subjects, jax_engine=False):
    cfg = (JConfig if jax_engine else ExperimentConfig).from_pars(
        dict(MULTI))
    expr = (JMulti(root, cfg) if jax_engine
            else MultiImgExperiment(root, cfg, device="cpu"))
    expr.attach_subjects(subjects[:2], subjects[2:])
    expr.prep_data()
    expr.add_method("random")
    res = expr.run_method("random", MULTI["k"])
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".npz"):
                os.remove(os.path.join(d, f))
    mdir = os.path.join(root, "random")
    picks = {f: open(os.path.join(mdir, "queries", f)).read()
             for f in sorted(os.listdir(os.path.join(mdir, "queries")))}
    return picks, np.asarray(res["perf"])


def test_multi_engine_takes_loaded_subjects(tmp):
    conv = tds.CONVENTIONS["iseg2017"]
    subjects = [tio.synthetic_subject(shape=(12, 12, 4), n_modalities=2,
                                      n_blobs=2, seed=10 + i)
                for i in range(3)]
    for i, (vols, mask) in enumerate(subjects):
        d = tmp / "data" / f"sub{i}"
        d.mkdir(parents=True)
        for name, v in zip(conv.modalities, vols):
            write_nifti(str(d / name), v)
        write_nifti(str(d / conv.mask), mask)
    loaded = [s.load() for s in
              tds.registry_for("iseg2017", str(tmp / "data")).subjects]
    j_loaded = [s.load() for s in
                jds.registry_for("iseg2017", str(tmp / "data")).subjects]
    files = _multi_round(str(tmp / "files"), loaded)
    memory = _multi_round(str(tmp / "memory"), subjects)
    jax_files = _multi_round(str(tmp / "jax"), j_loaded, jax_engine=True)
    assert files[0] == memory[0] == jax_files[0]
    assert len(files[0]) == 1
    np.testing.assert_array_equal(files[1], memory[1])
