"""The full-width 3-D FC-DenseNet-103's int8 gap against the reference, on
the CPU.

FC-DenseNet-103 at its published width and depth (growth 16, depths (4,
5, 7, 10, 12, 15)), 3-D on 2 modalities, at 32x32x32x2 (the smallest crop
its five poolings take), JAX's ``init_cnn`` seed 31, the port's copy
through ``models/bridge.from_jax_params``.  The input is the campaign
subject's first 32x32x32 crop (``synthetic_subject`` 128x128x32, seed 0,
each modality normalized), and the BN state is refreshed as
``chip_smoke.phase_rank3`` refreshes it: 2 train-mode passes at decay 0.6,
here over the crops at (32, 32, 0) and (64, 64, 0), by the JAX package.
Four posteriors of the one crop, on that state: JAX's f32, JAX's int8
(``quantize_params`` + ``apply_cnn``, jitted), the port's f32 and the
port's int8 (``quantize_params`` + ``quantized_cnn``).  The rules:

* the port's f32 within 1e-5 of JAX's (the rank-3 forward rule);
* the port's int8 within 0.1 of JAX's, with the same prediction on at
  least 95% of the voxels where JAX's p1 is more than 0.05 from 0.5
  (``tests/test_torch_rank3.py``'s int8 rule);
* the two int8 gaps (int8 against its own package's f32) agree: their
  max |dp1| within 0.01, their agreement rates overall and where the f32
  p1 is more than 0.05 from 0.5 within 0.01.

Slow: JAX's eager ``init_cnn`` compiles one random draw per distinct
parameter shape of the 108-layer net (about four minutes on a CPU), and
the four forwards take about a minute more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnal_tpu.models.cnn import apply_cnn
from nnal_tpu.models.cnn import init_cnn as j_init_cnn
from nnal_tpu.models.quant import quantize_params as j_quantize
from nnal_tpu.models.specs import create_tiramisu103 as j_tiramisu
from nnal_tpu.models.train import update_bn_stats as j_update_bn_stats
from nnal_tpu_torch.data.io import synthetic_subject
from nnal_tpu_torch.data.stats import multimg_stats
from nnal_tpu_torch.models.bridge import bn_state_to_port
from nnal_tpu_torch.models.quant import quantize_params, quantized_cnn
from nnal_tpu_torch.models.specs import create_tiramisu103 as t_tiramisu
from torch_jax_dense import port_model

pytestmark = pytest.mark.slow

torch.set_num_threads(1)

CROP = (32, 32, 32, 2)
SEED = 31


def _subject_crops():
    vols, mask = synthetic_subject(shape=(128, 128, 32), n_modalities=2,
                                   n_blobs=3, seed=0)
    stats = multimg_stats([(vols, mask)])[0]
    vol = np.stack([(np.asarray(v, np.float32) - m) / s for v, m, s in
                    zip(vols, stats[0::2], stats[1::2])], -1)

    def crop(x, y):
        return np.ascontiguousarray(
            vol[None, x:x + 32, y:y + 32, :32]).astype(np.float32)

    return crop(0, 0), [crop(32, 32), crop(64, 64)]


@pytest.fixture(scope="module")
def posteriors():
    jspec, tspec = j_tiramisu(2, CROP), t_tiramisu(2, CROP)
    params, state = j_init_cnn(jspec, jax.random.key(SEED))
    x, refresh = _subject_crops()
    it = iter(refresh)
    state = j_update_bn_stats(jspec, params, state, lambda: next(it),
                              iters=2, bn_decay=0.6)
    fwd = jax.jit(lambda p, s, h: apply_cnn(jspec, p, h, state=s).posteriors)
    qp = jax.tree_util.tree_map(jnp.asarray, j_quantize(jspec, params))
    params = jax.tree_util.tree_map(np.asarray, params)
    out = {"jax_f32": np.asarray(fwd(params, state, jnp.asarray(x))),
           "jax_int8": np.asarray(fwd(qp, state, jnp.asarray(x)))}
    ts = bn_state_to_port(jax.tree_util.tree_map(np.asarray, state), "cpu")
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out["port_f32"] = port_model(tspec, params)(
            xt, state=ts).posteriors.numpy()
        out["port_int8"] = quantized_cnn(
            tspec, quantize_params(tspec, params), device="cpu")(
            xt, state=ts).posteriors.numpy()
    return {k: v[..., 1] for k, v in out.items()}


def gap(got, want) -> dict:
    """max |dp1|, and the agreement of the predictions overall and where
    ``want``'s p1 is more than 0.05 from 0.5."""
    sure = np.abs(want - 0.5) > 0.05
    return {"max_abs_dp1": float(np.abs(got - want).max()),
            "agree": float(np.mean((got > 0.5) == (want > 0.5))),
            "agree_sure": float(np.mean((got > 0.5)[sure]
                                        == (want > 0.5)[sure]))}


def test_port_f32_matches_jax_f32(posteriors):
    p = posteriors
    assert all(v.shape == (1,) + CROP[:3] for v in p.values())
    assert np.abs(p["port_f32"] - p["jax_f32"]).max() <= 1e-5


def test_port_int8_tracks_jax_int8(posteriors):
    g = gap(posteriors["port_int8"], posteriors["jax_int8"])
    print("port int8 vs JAX int8:", g)
    assert g["max_abs_dp1"] <= 0.1 and g["agree_sure"] >= 0.95


def test_int8_gap_is_the_reference_own(posteriors):
    p = posteriors
    jg, tg = gap(p["jax_int8"], p["jax_f32"]), gap(p["port_int8"],
                                                   p["port_f32"])
    print("JAX int8 vs JAX f32:", jg, "port int8 vs port f32:", tg)
    for k in ("max_abs_dp1", "agree", "agree_sure"):
        assert abs(jg[k] - tg[k]) <= 0.01, k
