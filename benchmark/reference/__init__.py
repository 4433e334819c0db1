"""The plain reference the benchmark holds the port against.

Plain PyTorch in float32 with TF32 off, written from the published
descriptions of the models and of exact inner-product search: no kernel,
no cache, no batching. It imports nothing of the port and nothing of JAX;
the benchmark hands it the same seeded rows, weights and texts that it
hands to the port, and it works out everything the port derives from them
(the tokens, the forward, the mix, the exact top-k) again.
"""

import contextlib

import torch


@contextlib.contextmanager
def true_f32():
    """float32 matmuls as float32: TF32 off for cuBLAS and cuDNN inside the
    block, the previous settings restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
