"""Sequential AL across subjects (counterpart of
``nnal_tpu/engine/sequential.py``; reference ``PW_AL.sequential_AL``,
PW_AL.py:1295-1338): one single-subject experiment per subject, in order,
each warm-started from the previous subject's final weights."""

from __future__ import annotations

import os
import shutil
from typing import List

from nnal_tpu_torch.core.config import ExperimentConfig
from nnal_tpu_torch.core.journal import MethodJournal
from nnal_tpu_torch.engine.pw_experiment import PWExperiment


def sequential_al(root_dir: str, subjects: List, method_name: str,
                  max_queries: int, config: ExperimentConfig,
                  warm_start: bool = True, device=None) -> List:
    """``subjects``: ``(vols, mask)`` pairs; one ``subject_<i>`` experiment
    directory each, on ``device`` (default: the card).  ``warm_start``
    copies the previous subject's ``curr_weights.npz`` into the next
    one's method directory.  Re-invoking after a crash resumes: a method
    directory that already has its membership files is not set up again
    (``add_method`` would reset its weights and membership while its
    query journal survives), so completed subjects' ``run_method`` calls
    return at once."""
    results = []
    prev_weights = None
    for i, (vols, mask) in enumerate(subjects):
        sub_root = os.path.join(root_dir, f"subject_{i}")
        expr = PWExperiment(sub_root, config, device=device)
        expr.attach_subject(vols, mask)
        if not os.path.exists(os.path.join(sub_root, "init_pool_inds.txt")):
            expr.prep_data()
        if not os.path.exists(os.path.join(sub_root, method_name,
                                           "curr_train_inds.txt")):
            j = expr.add_method(method_name)
            if warm_start and prev_weights is not None:
                shutil.copy2(prev_weights, j.path("curr_weights.npz"))
        else:
            j = MethodJournal(sub_root, method_name)
        results.append(expr.run_method(method_name, max_queries))
        prev_weights = j.path("curr_weights.npz")
    return results
