"""What the per-layer metric readers share (``metrics/<name>.py``).  A
reader gets the traced run's record: the driver's ``record`` with the
reduced trace (``trace``) and the table of peaks (``peaks``) added, and
returns a number, or None where the record holds nothing to read."""


def idle(rec):
    """Percent of the traced window in which no operation ran on the
    card."""
    t = rec["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(rec):
    """Model FLOPs of the window (the benchmark's own count from the layer
    table) over the window's seconds, as a percent of the card's published
    float32 peak outside the tensor cores (TF32 is off)."""
    if not rec.get("model_flops") or rec["elapsed"] <= 0:
        return None
    return 100.0 * rec["model_flops"] / rec["elapsed"] \
        / rec["peaks"]["f32_flops"]


def phase_mean(rec, phase: str):
    """Seconds of the engine's ``phase`` per round of the window, from its
    ``PhaseTimer`` rows (the card is synchronised at every phase
    boundary)."""
    rows = rec.get("phases")
    if not rows:
        return None
    return sum(r.get(phase, 0.0) for r in rows) / len(rows)
