"""The window's model FLOPs over its seconds, as a percent of the f32 peak."""

from readers import mfu as read  # noqa: F401
