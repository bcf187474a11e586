"""Sparse linear learner (logistic regression) over padded CSR batches.

Counterpart of ``dmlc_tpu/models/linear.py``: the forward is the CSR SpMV
(kernel K1 on the card) and the weight gradient its transpose (kernel
K2), paired in ``ops.csr.segment_spmv``'s autograd function. Padded rows
carry weight 0, so they are loss- and gradient-neutral.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from dmlc_tpu_torch.models.common import SparseModelBase
from dmlc_tpu_torch.ops.csr import segment_spmv

__all__ = ["SparseLinearModel"]


class SparseLinearModel(SparseModelBase):
    """Logistic regression on sparse CSR batches, with parameters
    ``w[num_features]`` and ``b[]`` (zero-initialised, as the reference).

    Labels are mapped to {0, 1} via (label > 0) — accepts the ±1
    convention of libsvm files. ``device`` defaults to ``cuda``.
    """

    def __init__(self, num_features: int, l2: float = 0.0,
                 learning_rate: float = 0.1, device=None):
        super().__init__(l2=l2, learning_rate=learning_rate)
        device = torch.device("cuda" if device is None else device)
        self.num_features = num_features
        self.w = nn.Parameter(torch.zeros(num_features, device=device))
        self.b = nn.Parameter(torch.zeros((), device=device))

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Margins for one flat padded CSR batch."""
        margins = segment_spmv(batch["offset"], batch["index"],
                               batch["value"], self.w,
                               num_rows=batch["label"].shape[0])
        return margins + self.b
