"""Filesystem journal for AL experiments.

The reference uses the filesystem as its database: text files per run/method
(``parameters.txt``, ``{train,test,pool}_inds.txt``, ``queries/<iter>.txt``,
``accs.txt`` / ``perf_evals.txt``, weight checkpoints) and *replays* the
``queries/`` directory to resume interrupted campaigns (AL.py:182-190,307-317;
PW_AL.py:249-276,722-734).  This module keeps that replayable text layout for
tooling parity and adds one atomic JSON state record per round
(round id, RNG state, pool membership hashes) as the authoritative
resume point (SURVEY.md §5.3-5.4).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import numpy as np


def _atomic_write(path: str, payload: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_inds(path: str, inds) -> None:
    np.savetxt(path, np.asarray(inds, dtype=np.int64), fmt="%d")


def load_inds(path: str, matrix: bool = False) -> np.ndarray:
    """Load an int index file.

    ``matrix=True`` is for multi-subject (voxel, subject) query journals,
    which are ALWAYS 2 x k on disk: a k=1 file is textually identical to a
    1-D length-2 file (np.savetxt writes both as two one-value lines), so
    the caller's context — not the file — must disambiguate.  ``ndmin=2``
    keeps the (2, 1) shape that plain loadtxt would squeeze to (2,).
    """
    if os.path.getsize(path) == 0:
        # empty membership files are routine (e.g. init_size=0)
        return np.zeros((2, 0) if matrix else 0, dtype=np.int64)
    if matrix:
        return np.loadtxt(path, dtype=np.int64, ndmin=2)
    return np.atleast_1d(np.loadtxt(path, dtype=np.int64))


def append_row(path: str, row) -> None:
    """Append one whitespace-separated row (reference appends predicts/accs)."""
    row = np.atleast_1d(np.asarray(row))
    with open(path, "a") as f:
        f.write(" ".join(repr(float(v)) for v in row) + "\n")


class MethodJournal:
    """State of one (run, method) directory.

    Layout (mirrors AL.py:263-297 / PW_AL.py:249-276)::

        <root>/<method>/
            curr_train_inds.txt   curr_pool_inds.txt
            queries/<iter>.txt    perf_evals.txt (or accs.txt)
            state.json            curr_weights.npz ...
    """

    def __init__(self, root: str, method: str):
        self.dir = os.path.join(root, method)
        self.queries_dir = os.path.join(self.dir, "queries")
        os.makedirs(self.queries_dir, exist_ok=True)

    # ------------------------------------------------------------- paths
    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    @property
    def state_path(self) -> str:
        return self.path("state.json")

    # ------------------------------------------------------------- index state
    def init_membership(self, train_inds, pool_inds) -> None:
        save_inds(self.path("curr_train_inds.txt"), train_inds)
        save_inds(self.path("curr_pool_inds.txt"), pool_inds)

    def membership(self):
        return (
            load_inds(self.path("curr_train_inds.txt")),
            load_inds(self.path("curr_pool_inds.txt")),
        )

    def record_queries(self, iter_id: int, q_inds) -> None:
        save_inds(os.path.join(self.queries_dir, f"{iter_id}.txt"), q_inds)

    def query_iters(self):
        files = [f for f in os.listdir(self.queries_dir) if f.endswith(".txt")]
        return sorted(int(f[:-4]) for f in files)

    def replay_queries(self) -> np.ndarray:
        """Concatenate all recorded queries in iteration order
        (reference resume mechanism, PW_AL.py:722-734)."""
        out = []
        for it in self.query_iters():
            out.append(load_inds(os.path.join(self.queries_dir, f"{it}.txt")))
        return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)

    def n_queried(self, matrix: bool = False) -> int:
        """Total queried so far.  ``matrix=True`` for multi-subject
        journals whose files are (voxel, subject) 2 x k matrices — a k=1
        matrix file is indistinguishable from a 1-D length-2 file on
        disk, so auto-detection by ndim would double-count it."""
        total = 0
        for i in self.query_iters():
            arr = load_inds(os.path.join(self.queries_dir, f"{i}.txt"),
                            matrix=matrix)
            total += arr.shape[-1] if arr.ndim == 2 else len(arr)
        return int(total)

    # ------------------------------------------------------------- atomic state
    def save_state(self, *, round_id: int, rng_state: dict,
                   n_train: int, n_pool: int, extra: Optional[dict] = None) -> None:
        rec = {
            "round": int(round_id),
            "rng": rng_state,
            "n_train": int(n_train),
            "n_pool": int(n_pool),
        }
        if extra:
            rec["extra"] = extra
        _atomic_write(self.state_path, json.dumps(rec))

    def load_state(self) -> Optional[dict]:
        if not os.path.exists(self.state_path):
            return None
        with open(self.state_path) as f:
            return json.load(f)

    # ------------------------------------------------------------- metrics
    def append_eval(self, values, fname: str = "perf_evals.txt") -> None:
        append_row(self.path(fname), values)

    def load_evals(self, fname: str = "perf_evals.txt") -> np.ndarray:
        p = self.path(fname)
        if not os.path.exists(p):
            return np.zeros((0,))
        return np.atleast_1d(np.loadtxt(p))
