"""The multi-process dry run on the CPU (counterpart of
``__graft_entry__.dryrun_multichip`` and ``_dryrun_production_al_round``,
``__graft_entry__.py:25-300``).

:func:`dryrun_multichip` spawns ``n`` processes that join one ``gloo``
group over ``tcp://localhost`` and, in each, checks the process-group
code against one process:

* one DP(+TP) train step (``sharding.make_sharded_train_step``) on a
  model axis of 2 (when ``n`` is even) and on a data axis of ``n``: the
  gathered parameters and the loss within 1e-5 of one process's SGD step
  on the whole batch with the same dropout masks (a split sum rounds in
  another order, so bit identity is not to be had), then one Adam step
  whose loss is finite;
* ``sharding.sharded_pool_topk`` bit-identical to one process's top-k,
  with tied scores;
* one AL round over the data mesh: the entropy grid selector and fi's
  fused-FIM grid selector (values, rows, posteriors, shrunk gradients),
  the host's A-matrices, SDP and PMF draws, the dense segmenter, and the
  single-process z-sharded evaluator's posteriors, MC, FIM and perturb
  sweeps, all bit-identical to one process's sweeps; then a DP finetune
  step on the picks.

A card machine holds one card, so this is where the process-group code
is checked.  :func:`run_processes` and :func:`sharded_step_in_processes`
serve the tests too.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import socket
import tempfile

import numpy as np
import torch

__all__ = ["dryrun_multichip", "run_processes", "sharded_step_in_processes"]


def _require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_processes(n: int, target, *args) -> None:
    """``target(rank, n, port, *args)`` in ``n`` spawned processes that
    share a free localhost port for their process group; raises when one
    fails."""
    import torch.multiprocessing as mp

    mp.start_processes(target, args=(n, free_port()) + tuple(args),
                       nprocs=n, join=True, start_method="spawn")


def _join(rank, n, port):
    from nnal_tpu_torch.parallel.multihost import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"localhost:{port}", n, rank, device="cpu")


def _leave():
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def _rows(x, mesh):
    """This process's rows of a global batch (its data shard)."""
    import torch.distributed as dist

    d, _ = mesh.coords(dist.get_rank())
    b = x.shape[0] // mesh.shape["data"]
    return x[d * b:(d + 1) * b]


def _sharded_step(model, mesh, x, y, optimizer, lr, key,
                  tensor_parallel=True):
    """One sharded step from ``model``'s weights on the global batch;
    returns ``(full parameters, loss)``."""
    from nnal_tpu_torch.models.optim import make_optimizer
    from nnal_tpu_torch.models.train import TrainState
    from nnal_tpu_torch.parallel.sharding import (
        make_sharded_train_step,
        shard_params,
        unshard_params,
    )

    local = shard_params(model, mesh, tensor_parallel)
    state = TrainState(local, make_optimizer(optimizer, lr,
                                             local.parameters()))
    loss = make_sharded_train_step(mesh, tensor_parallel)(
        state, _rows(x, mesh), _rows(y, mesh), key)
    return unshard_params(local, mesh, tensor_parallel), float(loss)


def _step_worker(rank, n, port, model_parallel, spec, state_dict, x, y,
                 optimizer, lr, key, out_dir):
    from nnal_tpu_torch.models.cnn import CNN
    from nnal_tpu_torch.parallel.multihost import make_multihost_mesh

    _join(rank, n, port)
    model = CNN(spec)
    model.load_state_dict(state_dict)
    mesh = make_multihost_mesh(model_parallel, device="cpu")
    full, loss = _sharded_step(model, mesh, torch.as_tensor(x),
                               torch.as_tensor(y), optimizer, lr, key)
    if rank == 0:
        np.savez(os.path.join(out_dir, "step.npz"), __loss__=loss,
                 **{k: v.numpy() for k, v in full.items()})
    _leave()


def sharded_step_in_processes(n: int, model_parallel: int, spec,
                              state_dict, x, y, optimizer: str = "SGD",
                              lr: float = 1e-2, key=None):
    """One :func:`~nnal_tpu_torch.parallel.sharding.make_sharded_train_step`
    step in ``n`` gloo processes on a ``(n / model_parallel,
    model_parallel)`` mesh, from ``state_dict`` on the global batch ``x``
    (channels last), ``y`` (one-hots): ``(full parameters, loss)``."""
    out = tempfile.mkdtemp(prefix="nnal_step_")
    try:
        run_processes(n, _step_worker, model_parallel, spec,
                      {k: v.cpu() for k, v in state_dict.items()},
                      np.asarray(x, np.float32), np.asarray(y, np.float32),
                      optimizer, lr, key, out)
        with np.load(os.path.join(out, "step.npz")) as z:
            full = {k: torch.from_numpy(z[k]) for k in z.files
                    if k != "__loss__"}
            return full, float(z["__loss__"])
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _plain_step(model, x, y, lr, key):
    """One process's SGD step on the whole batch, the masks drawn as the
    sharded step draws them."""
    from nnal_tpu_torch.core import rng as core_rng

    ref = copy.deepcopy(model)
    opt = torch.optim.SGD(ref.parameters(), lr=lr)
    gen = None if key is None else core_rng.key_stream(key, x.device)
    logits = ref(x, train=True, generator=gen).logits
    loss = (-(y * torch.log_softmax(logits, -1)).sum(-1)).sum() / x.shape[0]
    opt.zero_grad()
    loss.backward()
    opt.step()
    return dict(ref.named_parameters()), float(loss.detach())


def _check_step(model, mesh, x, y, tag, report):
    full, loss = _sharded_step(model, mesh, x, y, "SGD", 1e-2, 7)
    ref, ref_loss = _plain_step(model, x, y, 1e-2, 7)
    err = max(float((full[k] - ref[k].detach()).abs().max()) for k in ref)
    _require(err <= 1e-5 and abs(loss - ref_loss) <= 1e-5 * abs(ref_loss),
             f"{tag} step: max |d| {err}, loss {loss} vs {ref_loss}")
    report[f"step_{tag}_max_abs_err"] = err
    full, loss = _sharded_step(model, mesh, x, y, "Adam", 1e-3, 7)
    _require(np.isfinite(loss), f"{tag} Adam step: loss {loss}")


def _al_round(n, report):
    """The production AL round (``_dryrun_production_al_round``)."""
    from nnal_tpu_torch.data.io import synthetic_subject
    from nnal_tpu_torch.data.patches import pad_volumes
    from nnal_tpu_torch.evaluation.inference import full_volume_patchwise
    from nnal_tpu_torch.models.cnn import init_cnn
    from nnal_tpu_torch.models.specs import create_model
    from nnal_tpu_torch.parallel.grid_sharded import ShardedGridPoolEvaluator
    from nnal_tpu_torch.parallel.mesh import make_mesh, stable_topk
    from nnal_tpu_torch.parallel.multihost import make_multihost_mesh
    from nnal_tpu_torch.parallel.pool_sharded import (
        grid_row_to_voxel,
        make_sharded_dense_segmenter,
        make_sharded_fim_grid_selector,
        make_sharded_grid_selector,
    )
    from nnal_tpu_torch.scoring.fisher import a_matrices
    from nnal_tpu_torch.scoring.grid_eval import GridPoolEvaluator
    from nnal_tpu_torch.scoring.pmf import sample_query_pmf
    from nnal_tpu_torch.scoring.sdp import fi_query_distribution

    mesh = make_multihost_mesh(1, device="cpu")
    z_inner, k, B, g = 2, 4, 8, 3
    ps = (9, 9, 1)
    shape = (18, 18, n * z_inner)
    vols, mask = synthetic_subject(shape=shape, n_modalities=1, seed=3)
    mu, sd = [float(np.mean(vols[0]))], [float(np.std(vols[0]) + 1e-6)]
    padded = pad_volumes(vols, ps, device="cpu")
    spec = create_model("PW", nclass=2, dropout_rate=0.5, patch_shape=ps)
    model = init_cnn(spec, 2, device="cpu")
    args = (spec, padded, mu, sd, ps, shape)
    ev = GridPoolEvaluator(*args, grid_spacing=g, z_chunk=z_inner)
    n_rows = ev.nx * ev.ny * shape[2]
    vox = grid_row_to_voxel(np.arange(n_rows), shape, g)

    p1 = torch.as_tensor(ev.evaluate(model, vox)["posteriors"])
    r_vals, r_rows = stable_topk(-(p1 - 0.5).abs(), k)
    s_vals, s_rows = make_sharded_grid_selector(
        mesh, ps, shape, g, k, z_inner)(model, padded, mu, sd)
    _require(np.array_equal(s_rows, r_rows.numpy())
             and np.array_equal(s_vals, r_vals.numpy()),
             f"entropy selection drift: {s_rows} vs {r_rows}")

    ref = ev.fim_sweep(model, as_device=True)
    rf_vals, rf_pos = stable_topk(-ref["uncertainty"], B)
    f_vals, f_rows, f_p1, f_shrunk = make_sharded_fim_grid_selector(
        mesh, ps, shape, g, B, z_inner)(model, padded, mu, sd)
    _require(np.array_equal(f_rows, rf_pos.numpy())
             and np.array_equal(f_vals, rf_vals.numpy())
             and np.array_equal(f_p1, ref["p1"][rf_pos].numpy())
             and np.array_equal(f_shrunk, ref["shrunk"][rf_pos].numpy()),
             "fi candidate drift")
    draws = []
    for sh, pp in ((f_shrunk, f_p1), (ref["shrunk"][rf_pos].numpy(),
                                      ref["p1"][rf_pos].numpy())):
        q = fi_query_distribution(a_matrices(torch.as_tensor(sh),
                                             torch.as_tensor(pp)), 0.0,
                                  None, k, device="cpu")
        draws.append(sample_query_pmf(q, k, np.random.default_rng(7)))
    _require(np.array_equal(*draws), "fi PMF drift")

    seg = make_sharded_dense_segmenter(mesh, ps, shape)(model, padded, mu,
                                                         sd)
    _require(np.array_equal(seg, full_volume_patchwise(ev, model,
                                                       "posteriors")),
             "sharded serving drift")

    ev_sh = ShardedGridPoolEvaluator(make_mesh(n, device="cpu"), *args,
                                     grid_spacing=g, z_chunk=z_inner)
    for kw in ({}, {"mc_rng": 11}):
        _require(np.array_equal(ev.evaluate(model, vox, **kw)["posteriors"],
                                ev_sh.evaluate(model, vox, **kw)[
                                    "posteriors"]), f"sweep drift {kw}")
    f1, f2 = ev.fim_sweep(model), ev_sh.fim_sweep(model)
    _require(all(np.array_equal(f1[key], f2[key]) for key in f1)
             and np.array_equal(ev.perturb_sweep(model, 5),
                                ev_sh.perturb_sweep(model, 5)),
             "FIM or perturb sweep drift")

    # a DP finetune step on the picks (labels from the mask), tiled up to
    # 4 rows a process (the PMF deduplicates its draws)
    picks = grid_row_to_voxel(f_rows[draws[0]], shape, g)
    from nnal_tpu_torch.data.patches import gather_patches_normalized

    x = gather_patches_normalized(
        padded, torch.as_tensor(picks), torch.tensor(mu, dtype=torch.float32),
        torch.tensor(sd, dtype=torch.float32), ps, shape)
    lab = np.nan_to_num(np.asarray(mask).ravel()[picks]).astype(np.int64)
    y = torch.nn.functional.one_hot(torch.as_tensor(lab), 2).float()
    reps = -(-(4 * n) // len(picks))
    x, y = x.repeat(reps, 1, 1, 1)[:4 * n], y.repeat(reps, 1)[:4 * n]
    _, loss = _sharded_step(model, mesh, x, y, "Adam", 1e-3, 5)
    _require(np.isfinite(loss), f"finetune loss {loss}")
    report["al_round"] = "bit-identical"
    report["picks"] = picks.tolist()


def _dryrun_worker(rank, n, port, out_dir):
    from nnal_tpu_torch.models.cnn import init_cnn
    from nnal_tpu_torch.models.specs import create_model
    from nnal_tpu_torch.ops.scoring_fused import pool_score_fused
    from nnal_tpu_torch.parallel.mesh import stable_topk
    from nnal_tpu_torch.parallel.multihost import make_multihost_mesh
    from nnal_tpu_torch.parallel.sharding import sharded_pool_topk

    _join(rank, n, port)
    report = {"n": n}
    spec = create_model("PW", nclass=2, dropout_rate=0.5,
                        patch_shape=(15, 15, 2))
    model = init_cnn(spec, 0, device="cpu")
    rng = np.random.default_rng(1)
    b = 4 * n
    x = torch.as_tensor(rng.normal(size=(b, 15, 15, 2)).astype(np.float32))
    y = torch.nn.functional.one_hot(torch.arange(b) % 2, 2).float()
    if n % 2 == 0:
        _check_step(model, make_multihost_mesh(2, device="cpu"), x, y,
                    "tp2", report)
    dmesh = make_multihost_mesh(1, device="cpu")
    _check_step(model, dmesh, x, y, f"dp{n}", report)

    # the sharded pool top-k, with every second patch repeated (ties)
    pool = torch.as_tensor(rng.normal(size=(8 * n, 15, 15, 2)).astype(
        np.float32))
    pool[1::2] = pool[0::2]

    def score_fn(m, patches):
        return -pool_score_fused(m, patches, with_fim=False)["uncertainty"]

    vals, idx = sharded_pool_topk(dmesh, score_fn, 5)(model, _rows(pool,
                                                                  dmesh))
    # one process scores the same shards (a batch's size may move the
    # convolutions' last bits), then takes one top-k
    r_vals, r_idx = stable_topk(torch.cat([score_fn(model, c)
                                           for c in pool.chunk(n)]), 5)
    _require(torch.equal(vals, r_vals) and torch.equal(idx, r_idx),
             f"sharded top-k {idx} vs {r_idx}")
    report["topk"] = "bit-identical"
    _al_round(n, report)
    if rank == 0:
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(report, f)
    _leave()


def dryrun_multichip(n_devices: int) -> dict:
    """The dry run in ``n_devices`` gloo CPU processes (module docstring);
    returns rank 0's report and prints it."""
    out = tempfile.mkdtemp(prefix="nnal_dryrun_")
    try:
        run_processes(int(n_devices), _dryrun_worker, out)
        with open(os.path.join(out, "report.json")) as f:
            report = json.load(f)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(f"dryrun_multichip({n_devices}): " + json.dumps(report))
    return report


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
