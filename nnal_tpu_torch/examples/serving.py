"""Serving a trained patch model: dense segmentation and quantization
(counterpart of ``examples/serving.py``).

* A supervised warm-up stands in for a campaign: the grid's patches are
  gathered on the device (kernel K2 on the card) and
  ``models/train.make_train_step`` takes Adam steps on them.
* Every voxel of the subject is scored through the patch model by one
  ``evaluation/inference.full_slice_patchwise`` call over a stride-1
  ``GridPoolEvaluator`` (one im2col sweep per touched z-slab).
* int8 post-training quantization (``models/quant.quantize_params``:
  per-output-channel int8 weights, dynamic activation scales) serves the
  same sweep; its F and its agreement with float are reported.
* ``FCNInference.segment`` runs an FC-DenseNet's dense ops
  (``posteriors``, ``MC-posteriors``) over the slice stack.
"""

from __future__ import annotations

from nnal_tpu_torch.examples._cli import parser


def train_patch_model(spec, vols, mask, mu, sd, patch_shape, steps,
                      seed=0, device=None):
    """Supervised warm-up on a labeled grid at spacing 2 (Adam 1e-3, b
    256); returns the trained :class:`~nnal_tpu_torch.models.cnn.CNN`."""
    import numpy as np
    import torch

    from nnal_tpu_torch.core.device import resolve_device
    from nnal_tpu_torch.core.rng import fold_key
    from nnal_tpu_torch.data.batching import make_onehot
    from nnal_tpu_torch.data.patches import (gather_labels,
                                             gather_patches_normalized,
                                             pad_volumes)
    from nnal_tpu_torch.data.samplers import generate_grid_samples
    from nnal_tpu_torch.models.cnn import init_cnn
    from nnal_tpu_torch.models.train import (init_train_state,
                                             make_train_step)

    dev = resolve_device(device)
    shape = tuple(np.asarray(vols[0]).shape)
    inds = generate_grid_samples(shape, 2)
    padded = pad_volumes(vols, patch_shape, dev)
    x = gather_patches_normalized(
        padded, torch.as_tensor(inds, device=dev),
        torch.as_tensor(np.asarray(mu, np.float32), device=dev),
        torch.as_tensor(np.asarray(sd, np.float32), device=dev),
        patch_shape, shape)
    y = torch.as_tensor(
        make_onehot(np.asarray(gather_labels(mask, inds, shape),
                               np.int64), 2), dtype=torch.float32,
        device=dev)
    state = init_train_state(init_cnn(spec, seed, dev), "Adam", 1e-3)
    step = make_train_step()
    b = 256
    loss = torch.zeros(())
    for i in range(steps):
        lo = (i * b) % max(1, x.shape[0] - b)
        loss = step(state, x[lo:lo + b], y[lo:lo + b],
                    fold_key(seed + 1, i))
        state.step += 1
    print(f"warm-up done ({steps} steps, final loss {float(loss):.3f})")
    return state.model


def main(tiny: bool = False, device=None) -> dict:
    import numpy as np

    from nnal_tpu_torch.core.device import resolve_device
    from nnal_tpu_torch.data.io import synthetic_subject
    from nnal_tpu_torch.data.patches import pad_volumes
    from nnal_tpu_torch.evaluation.inference import (FCNInference,
                                                     full_slice_patchwise)
    from nnal_tpu_torch.evaluation.metrics import f_measure
    from nnal_tpu_torch.models.bridge import to_jax_params
    from nnal_tpu_torch.models.cnn import init_cnn
    from nnal_tpu_torch.models.quant import quantize_params, quantized_cnn
    from nnal_tpu_torch.models.specs import create_model, create_tiramisu103
    from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator

    dev = resolve_device(device)
    shape = (24, 24, 6) if tiny else (48, 48, 12)
    steps = 10 if tiny else 150
    vols, mask = synthetic_subject(shape=shape, n_modalities=2, n_blobs=8,
                                   seed=3)
    mu = np.array([float(np.nanmean(v)) for v in vols])
    sd = np.array([float(np.nanstd(v)) + 1e-6 for v in vols])
    patch_shape = (9, 9, 1)
    spec = create_model("PW", nclass=2, dropout_rate=0.2,
                        patch_shape=(9, 9, len(vols)))
    model = train_patch_model(spec, vols, mask, mu, sd, patch_shape, steps,
                              device=dev)

    # ---- dense per-voxel segmentation through the patch model ----------
    ev = GridPoolEvaluator(spec, pad_volumes(vols, patch_shape, dev), mu,
                           sd, patch_shape, shape, grid_spacing=1, ntb=4096)
    zs = list(range(shape[2]))
    planes = full_slice_patchwise(ev, model, zs, op="prediction")
    pred = np.stack([planes[z] for z in zs], axis=2)
    f_float = f_measure(pred.ravel(), np.nan_to_num(mask).ravel())
    print(f"dense patch-model segmentation: F={f_float:.3f} "
          f"over {pred.size} voxels")

    # ---- int8 post-training quantization --------------------------------
    qmodel = quantized_cnn(
        spec, quantize_params(spec, to_jax_params(model.state_dict())),
        device=dev)
    planes_q = full_slice_patchwise(ev, qmodel, zs, op="prediction")
    pred_q = np.stack([planes_q[z] for z in zs], axis=2)
    agree = float(np.mean(pred_q == pred))
    f_int8 = f_measure(pred_q.ravel(), np.nan_to_num(mask).ravel())
    print(f"int8 serving: F={f_int8:.3f}, voxel agreement with float "
          f"{agree:.4f}")

    # ---- FCN dense inference (untrained net; shows the op set) ---------
    fcn_spec = create_tiramisu103(2, (shape[0], shape[1], len(vols)),
                                  growth=2, depths=(2, 2))
    fcn = init_cnn(fcn_spec, 7, dev)
    slices = np.stack([np.stack([np.asarray(v)[:, :, z] for v in vols],
                                axis=-1) for z in zs]).astype(np.float32)
    inf = FCNInference(fcn_spec, batch=4, device=dev)
    post = inf.segment(fcn, slices, op="posteriors")
    mc = inf.segment(fcn, slices, op="MC-posteriors", mc_T=3)
    print(f"FCN ops: posteriors {post.shape}, MC-posteriors {mc.shape} "
          "(plus prediction/output/loss/sigma/MC-sigma)")
    return {"f_float": f_float, "f_int8": f_int8, "agreement": agree}


if __name__ == "__main__":
    a = parser("serving", root=False).parse_args()
    main(a.tiny, a.device)
