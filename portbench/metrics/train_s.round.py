"""Seconds of the engine's ``train`` phase per round of the window."""

from readers import phase_mean


def read(rec):
    return phase_mean(rec, "train")
