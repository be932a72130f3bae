"""Multi-device pool scoring and training (counterpart of
``nnal_tpu/parallel``): meshes, the z-sharded evaluator, the sharded
selectors and segmenter, the DP(+TP) step over ``torch.distributed``,
multi-process initialization and the ``gloo`` dry run."""
