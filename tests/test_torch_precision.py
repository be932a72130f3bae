"""The IEEE-f32 precision policy (``core/device``) on every entry point of
the port, on the CPU.

PyTorch's process-wide defaults let cuDNN run f32 convolutions in TF32 and
bf16 GEMMs reduce in bf16.  Each case below starts from those defaults,
with TF32 matrix products switched on as well, then makes the calls a
user makes for one entry point with ``device="cpu"`` at a tiny size (the
makers the entry point needs included), and asserts that all three flags
come back in the IEEE policy: ``cudnn.allow_tf32``,
``cuda.matmul.allow_tf32`` and
``cuda.matmul.allow_bf16_reduced_precision_reduction`` all False (and
cuDNN's convolution precision no longer ``'tf32'``).  The flags are
restored after each case.  The module's fixtures (the model weights, a
one-round campaign) are made before the flags are switched on.
"""

import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from nnal_tpu_torch.cli.run_on_subjects import run_on_subjects
from nnal_tpu_torch.cli.softmax_harness import run_comparison, synthetic_mnist
from nnal_tpu_torch.core.config import ExperimentConfig
from nnal_tpu_torch.core.device import resolve_device
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.data.patches import pad_volumes
from nnal_tpu_torch.engine import analysis as eng_analysis
from nnal_tpu_torch.engine.experiment import Experiment
from nnal_tpu_torch.engine.multi_experiment import MultiImgExperiment
from nnal_tpu_torch.engine.pw_experiment import PWExperiment
from nnal_tpu_torch.evaluation import analysis as ev_analysis
from nnal_tpu_torch.evaluation.crf import dcrf_postprocess_2d
from nnal_tpu_torch.evaluation.inference import (
    FCNInference,
    ShapeCachedFCN,
    full_volume_patchwise,
)
from nnal_tpu_torch.models.bridge import to_jax_params
from nnal_tpu_torch.models.cnn import init_cnn
from nnal_tpu_torch.models.quant import quantize_params, quantized_cnn
from nnal_tpu_torch.models.specs import create_model
from nnal_tpu_torch.models.train import (
    TrainState,
    init_train_state,
    make_train_step,
    train,
)
from nnal_tpu_torch.parallel import multihost
from nnal_tpu_torch.parallel.dryrun import free_port
from nnal_tpu_torch.parallel.sharding import (
    make_sharded_train_step,
    shard_params,
)
from nnal_tpu_torch.scoring.fcn_eval import FCNGridPoolEvaluator
from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator
from nnal_tpu_torch.scoring.pool_eval import PoolEvaluator

torch.set_num_threads(1)

PS = (9, 9, 1)
SHAPE = (20, 20, 6)
PARS = {"model_name": "PW", "nclass": 2, "patch_shape": PS,
        "grid_spacing": 4, "k": 3, "B": 12, "ntb": 256, "b": 32,
        "epochs": 1, "learning_rate": 3e-4, "optimizer_name": "Adam",
        "dropout_rate": 0.2, "init_size": 4, "seed": 5}
DENSE = dict(nclass=2, input_shape=(16, 16, 2), dropout_rate=0.2, growth=4,
             depths=(2, 2))


def flags():
    b = torch.backends
    return (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
            b.cuda.matmul.allow_bf16_reduced_precision_reduction)


def set_flags(values):
    b = torch.backends
    (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
     b.cuda.matmul.allow_bf16_reduced_precision_reduction) = values


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    """A one-round ``random`` campaign of PW1 (9x9x1, 2 modalities) on a
    20x20x6 subject, its weights as a model, a small FC-DenseNet and its
    slices; the campaign's directory is deleted at the end."""
    top = tmp_path_factory.mktemp("precision")
    try:
        vols, mask = synthetic_subject(shape=SHAPE, n_modalities=2, seed=5,
                                       n_blobs=6)
        expr = PWExperiment(str(top / "expr"),
                            ExperimentConfig.from_pars(dict(PARS)),
                            device="cpu")
        expr.attach_subject(vols, mask)
        expr.prep_data()
        expr.add_method("random")
        expr.run_method("random", PARS["k"])
        spec = expr.build_model()
        dspec = create_model("Tiramisu", **DENSE)
        yield {"top": top, "vols": vols, "mask": mask, "expr": expr,
               "spec": spec, "model": init_cnn(spec, 0, device="cpu"),
               "dspec": dspec, "dmodel": init_cnn(dspec, 0, device="cpu"),
               "slices": np.random.default_rng(0).normal(
                   size=(2, 16, 16, 2)).astype(np.float32)}
    finally:
        shutil.rmtree(top, ignore_errors=True)


def _grid_ev(c, spacing=4):
    vols = c["vols"]
    return GridPoolEvaluator(
        c["spec"], pad_volumes(vols, PS, device="cpu"), [0.0, 0.0],
        [1.0, 1.0], PS, SHAPE, grid_spacing=spacing, ntb=256)


def _pool_ev(c):
    return PoolEvaluator(c["spec"], pad_volumes(c["vols"], PS, device="cpu"),
                         [0.0, 0.0], [1.0, 1.0], PS, SHAPE, ntb=256)


def _sharded_step(c):
    """``make_sharded_train_step`` in a world of one ``gloo`` process (the
    group and the mesh are made first, as each process of a mesh does)."""
    multihost.init_distributed(f"localhost:{free_port()}", 1, 0,
                               device="cpu")
    try:
        mesh = multihost.make_multihost_mesh(1, device="cpu")
        local = shard_params(c["model"], mesh)
        state = TrainState(local, torch.optim.SGD(local.parameters(),
                                                  lr=1e-3))
        set_flags((True, True, True))
        x = torch.zeros((4,) + PS[:2] + (2,))
        y = torch.nn.functional.one_hot(torch.arange(4) % 2, 2).float()
        make_sharded_train_step(mesh)(state, x, y, 1)
    finally:
        dist.destroy_process_group()


def _train(c):
    model = c["model"]
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
    x = torch.zeros((4,) + PS[:2] + (2,))
    y = torch.nn.functional.one_hot(torch.arange(4) % 2, 2).float()
    train(state, make_train_step(), iter([(x, y)]), step_limit=1, rng=0)


def _analysis_eval(c, name):
    ev = c["expr"].make_evaluator(c["spec"])
    vols, mask = c["vols"], c["mask"]
    if name == "grid_based_f1":
        ev_analysis.grid_based_f1(ev, c["model"], mask, spacing=4)
    elif name == "full_model_eval":
        ev_analysis.full_model_eval(ev, c["model"], mask, [2])
    else:
        ev_analysis.full_model_pred_dcrf(ev, c["model"], vols[0], mask, [2],
                                         iters=1, backend="torch")


CASES = {
    "run_on_subjects": lambda c: run_on_subjects(
        c["expr"], "random", [(c["vols"], c["mask"])], device="cpu"),
    "full_volume_patchwise": lambda c: full_volume_patchwise(
        _grid_ev(c), c["model"], "posteriors"),
    "FCNInference": lambda c: FCNInference(c["dspec"], device="cpu").segment(
        c["dmodel"], c["slices"], "posteriors"),
    "ShapeCachedFCN": lambda c: ShapeCachedFCN(
        lambda s: create_model("Tiramisu", **{**DENSE, "input_shape":
                                              tuple(s) + (2,)}),
        device="cpu").for_shape((16, 16)).segment(c["dmodel"], c["slices"]),
    "GridPoolEvaluator": lambda c: _grid_ev(c).evaluate(
        c["model"], np.arange(8)),
    "PoolEvaluator": lambda c: _pool_ev(c).evaluate(c["model"],
                                                    np.arange(8)),
    "FCNGridPoolEvaluator": lambda c: FCNGridPoolEvaluator(
        c["dspec"], [np.ones((16, 16, 2), np.float32)] * 2, [0.0, 0.0],
        [1.0, 1.0], (16, 16, 2), device="cpu").evaluate(c["dmodel"],
                                                        np.arange(8)),
    "grid_based_f1": lambda c: _analysis_eval(c, "grid_based_f1"),
    "full_model_eval": lambda c: _analysis_eval(c, "full_model_eval"),
    "full_model_pred_dcrf": lambda c: _analysis_eval(c, "dcrf"),
    "query_similarity_analysis": lambda c:
        eng_analysis.query_similarity_analysis(c["expr"], "random"),
    "slice_query_preds": lambda c: eng_analysis.slice_query_preds(
        c["expr"], "random", 2),
    "query_type_analysis": lambda c: eng_analysis.query_type_analysis(
        c["expr"], "random"),
    "full_test_slice_dcrf": lambda c: eng_analysis.full_test_slice_dcrf(
        [c["expr"]], "random", slice_step=3, backend="torch"),
    "dcrf_postprocess_2d": lambda c: dcrf_postprocess_2d(
        np.full((8, 8), 0.7, np.float32), np.ones((8, 8), np.float32),
        iters=1, backend="torch", device="cpu"),
    "make_train_step+train": _train,
    "init_train_state": lambda c: init_train_state(c["model"], "Adam"),
    "make_sharded_train_step": _sharded_step,
    "quantized_cnn": lambda c: quantized_cnn(
        c["dspec"], quantize_params(c["dspec"], to_jax_params(
            c["dmodel"].state_dict())), device="cpu"),
    "PWExperiment": lambda c: PWExperiment(str(c["top"] / "pw"),
                                           ExperimentConfig.from_pars(
                                               dict(PARS)), device="cpu"),
    "MultiImgExperiment": lambda c: MultiImgExperiment(
        str(c["top"] / "multi"), ExperimentConfig.from_pars(dict(PARS)),
        device="cpu"),
    "Experiment": lambda c: Experiment(str(c["top"] / "cls"),
                                       ExperimentConfig.from_pars(
                                           dict(PARS)), device="cpu"),
    "softmax_harness": lambda c: run_comparison(
        *synthetic_mnist(n_per_class=10, nclass=3, d=8), 3, k=2, rounds=1,
        init_size=6, steps=2, device="cpu"),
}


@pytest.fixture
def restored_flags():
    before = flags()
    yield
    set_flags(before)


@pytest.mark.parametrize("name", sorted(CASES))
def test_entry_point_applies_the_ieee_policy(ctx, name, restored_flags):
    set_flags((True, True, True))
    assert flags() == (True, True, True)
    CASES[name](ctx)
    assert flags() == (False, False, False), name
    conv = getattr(getattr(torch.backends.cudnn, "conv", None),
                   "fp32_precision", None)
    assert conv != "tf32", name


def test_resolve_device_applies_it_on_any_device(restored_flags):
    for device in ("cpu", torch.device("cpu"), "meta"):
        set_flags((True, True, True))
        assert resolve_device(device).type == torch.device(device).type
        assert flags() == (False, False, False)
