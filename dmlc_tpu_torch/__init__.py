"""dmlc_tpu_torch: the PyTorch/CUDA port of dmlc_tpu.

The module layout mirrors ``dmlc_tpu``: each module here has its
counterpart at the same path there, and the JAX package stays the
reference the tests hold this one to. This package imports torch and
numpy, never jax, and nothing of ``dmlc_tpu``.

Ported so far (the main path): local-file ``InputSplit``, the libsvm
parser (Python golden and native C++ engine, with ABI-5 padded batch
assembly), bucket padding, the pinned async host→device iterator, the
CSR SpMV kernels with their weight-gradient transpose, and
``SparseLinearModel`` SGD. Entry points that touch a device default to
``torch.device("cuda")``; pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels.
"""

from dmlc_tpu_torch.utils.logging import DMLCError
from dmlc_tpu_torch.data.parser import Parser
from dmlc_tpu_torch.data import libsvm_parser as _libsvm  # registers "libsvm"

__all__ = ["DMLCError", "Parser"]

del _libsvm
