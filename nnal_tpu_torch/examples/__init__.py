"""Runnable end-to-end examples of the port (counterparts of the JAX
package's ``examples/`` scripts), each run as::

    python -m nnal_tpu_torch.examples.<name> [--tiny] [--device cpu]

``patchwise_al``, ``multi_subject_al``, ``classification_al``,
``serving``, ``dense_model_al`` and ``multichip_campaign``.  Each
``main(...)`` takes the JAX script's arguments, defaults and ``--tiny``
settings and returns what it returns, plus a ``device`` argument: the
card by default (a missing CUDA device raises, naming ``device="cpu"``),
``"cpu"`` for the host.  The data is synthetic, made from seeds.
"""
