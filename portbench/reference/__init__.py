"""The plain reference of the benchmark's configurations: plain PyTorch
and NumPy, importing nothing of the program under test."""

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    """IEEE float32 in cuBLAS and cuDNN (``tf32`` False), or TF32 on the
    tensor cores for both (the control); the flags are restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
