"""Seconds of the engine's ``eval`` phase per round of the window."""

from readers import phase_mean


def read(rec):
    return phase_mean(rec, "eval")
