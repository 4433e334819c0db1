"""PyTorch + CUDA port of the code-mixed multilingual dense-retrieval system.

The package mirrors ``codemix_dense_retrieval_tpu``'s layout (``ops``,
``models``, ``index``, ``parallel``, ``pipeline``, ``io``, ``evals``) so each
module's counterpart is found by name. It imports ``torch`` and never JAX.
Entry points run on a CUDA device unless the caller passes ``device="cpu"``;
with no CUDA device and none named they raise.

The TPU Pallas kernels on the main path are hand-written CUDA C++ kernels for
Hopper (``csrc/``), each beside a plain PyTorch version of the same function
that serves CPU tensors and is the kernel's oracle on the card.
"""

__version__ = "0.1.0"
