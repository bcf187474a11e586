"""Sparse linear learner (logistic regression) over padded CSR batches.

Counterpart of ``dmlc_tpu/models/linear.py``: the margin is the CSR SpMV
(kernel K1 on the card) plus the bias, and the weight gradient its
transpose (kernel K2), paired in ``ops.csr.segment_spmv``'s autograd
function, and on a sharded batch in ``ops.csr.parts_spmv``'s (K2 once
for all of a process's parts); the step's objective is K8 and its update K9
(``models.common``). Padded rows carry weight 0, so they are loss- and
gradient-neutral.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

from dmlc_tpu_torch.models.common import SparseModelBase
from dmlc_tpu_torch.ops.csr import parts_spmv, segment_spmv

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

    def _margin_terms(self, batch: Dict[str, Any]) -> List[torch.Tensor]:
        return [segment_spmv(batch["offset"], batch["index"],
                             batch["value"], self.w,
                             num_rows=batch["label"].shape[0])]

    def _parts_margin_terms(self, batch: Dict[str, Any]
                            ) -> List[torch.Tensor]:
        return [parts_spmv(batch["offset"], batch["index"], batch["value"],
                           self.w)]

    def predict_proba(self, batch: Dict[str, Any]) -> torch.Tensor:
        return torch.sigmoid(self(batch))
