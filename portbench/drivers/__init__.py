"""One driver per traffic kind and model family: ``<driver>_<family>.py``,
each with ``setup``, ``window``, ``end_to_end``, ``record``, ``release``
and ``check``."""
