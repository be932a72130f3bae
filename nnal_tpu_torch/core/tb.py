"""Optional TensorBoard event mirror (a copy of ``nnal_tpu/core/tb.py``).

The txt/JSONL journals are the source of truth; TensorBoard is an optional
*mirror*.  When ``torch.utils.tensorboard`` imports (it needs the
``tensorboard`` package), scalars are duplicated into ``tfevents`` files;
otherwise every call is a no-op, as in the JAX package, and ``active`` is
False.  Experiments never depend on it.
"""

from __future__ import annotations

from typing import Optional


class TBWriter:
    """Scalar event writer; inert without a backend."""

    def __init__(self, logdir: Optional[str]):
        self._w = None
        if not logdir:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._w = SummaryWriter(logdir)
        except Exception:
            self._w = None

    @property
    def active(self) -> bool:
        return self._w is not None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._w is not None:
            self._w.add_scalar(tag, float(value), int(step))

    def scalars(self, values: dict, step: int) -> None:
        for tag, v in values.items():
            self.scalar(tag, v, step)

    def flush(self) -> None:
        if self._w is not None:
            self._w.flush()

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None
