"""Percent of the traced window in which no operation ran on the card."""

from readers import idle as read  # noqa: F401
