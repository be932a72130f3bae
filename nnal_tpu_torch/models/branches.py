"""Model branches and replication (counterpart of
``nnal_tpu/models/branches.py``).

The reference grows a secondary head off a probed layer of a built graph
(``create_branch``, NN_extended.py:1085-1118) and clones a graph under a
new variable scope (``replicate_model``, NN_extended.py:1677).  Here a
branch is a second :class:`~nnal_tpu_torch.models.cnn.CNN` applied to the
trunk's probe output (``forward(..., keep_probes=True)``, channels-last
as the JAX package's probes), and a replica is a deep copy of a model.
"""

from __future__ import annotations

import copy
from typing import Tuple

import torch

from nnal_tpu_torch.models.cnn import CNN, CNNOutput, _trace_channels, init_cnn
from nnal_tpu_torch.models.specs import CNNSpec


def branch_input_shape(trunk: CNNSpec, probe_index: int) -> Tuple[int, ...]:
    """The sample shape of layer ``probe_index``'s output (channels-last),
    to size a branch spec's ``input_shape``."""
    return tuple(_trace_channels(trunk)[probe_index][2])


def init_branch(branch: CNNSpec, seed: int, device=None) -> CNN:
    """A He-initialized branch network (``models/cnn.init_cnn``; None: on
    the card)."""
    return init_cnn(branch, seed, device)


def apply_with_branch(trunk: CNN, branch: CNN, x: torch.Tensor,
                      probe_index: int, **kw
                      ) -> Tuple[CNNOutput, CNNOutput]:
    """Forward through the trunk, then run the branch on the probed
    activation; ``kw`` (``train``, ``generator``, ...) goes to both
    forwards.  ``probe_index`` must be listed in ``trunk.spec.probes``."""
    if probe_index not in trunk.spec.probes:
        raise ValueError(f"layer {probe_index} is not probed by "
                         f"{trunk.spec.name} (probes {trunk.spec.probes})")
    trunk_out = trunk(x, keep_probes=True, **kw)
    h = trunk_out.probes[trunk.spec.layers[probe_index].name]
    return trunk_out, branch(h, **kw)


def replicate_params(model: CNN) -> CNN:
    """An independent copy of ``model`` (its own parameters on the same
    device; reference ``replicate_model``)."""
    return copy.deepcopy(model)
