"""Pairwise ranking (RankNet) over padded CSR batches, the consumer of the
libsvm ``qid`` column.

Counterpart of ``dmlc_tpu/models/ranking.py``. Scores are
``m_i = w·x_i + b`` (the CSR SpMV, kernel K1 on the card, gradient K2);
for documents i, j of the same query with label_i > label_j the loss is
softplus(−(m_i − m_j)), weighted by weight_i·weight_j and averaged over
the pairs (kernel K7, forward and backward, ``ops.ranking``). Padded rows
are neutral twice over: qid −1 matches no query, and weight 0 zeroes
their pairs.

K7 sweeps the pairs in tiles and never holds an ``[n, n]`` array, but the
model keeps the reference's ``max_row_bucket`` (4096 by default), raised
before any launch: the two packages refuse the same batches.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from dmlc_tpu_torch.models.common import SparseModelBase
from dmlc_tpu_torch.ops.csr import segment_spmv
from dmlc_tpu_torch.ops.ranking import pair_sums_autograd, pair_weights_plain
from dmlc_tpu_torch.utils.logging import DMLCError

__all__ = ["SparseRankingModel"]


class SparseRankingModel(SparseModelBase):
    """Linear scorer with the pairwise logistic (RankNet) loss, with
    parameters ``w[num_features]`` and ``b[]`` (zero-initialised, as the
    reference). Batches must carry ``qid`` (the libsvm parser fills it;
    the padding forwards it with −1). ``device`` defaults to ``cuda``."""

    _BATCH_KEYS = ("offset", "index", "value", "qid")

    def __init__(self, num_features: int, l2: float = 0.0,
                 learning_rate: float = 0.1, max_row_bucket: int = 4096,
                 device=None):
        super().__init__(l2=l2, learning_rate=learning_rate)
        device = torch.device("cuda" if device is None else device)
        self.num_features = num_features
        self.max_row_bucket = max_row_bucket
        self.w = nn.Parameter(torch.zeros(num_features, device=device))
        self.b = nn.Parameter(torch.zeros((), device=device))

    def validate_batch(self, batch: Dict[str, Any]) -> None:
        """Host-side guard: the batch must carry every column the
        objective consumes, notably ``qid`` (the libsvm parser fills it
        only when the file has qid: tokens)."""
        self._check_columns(batch)

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Scores for one flat padded CSR batch."""
        margins = segment_spmv(batch["offset"], batch["index"],
                               batch["value"], self.w,
                               num_rows=batch["label"].shape[0])
        return margins + self.b

    def _block_objective(self, batch: Dict[str, Any]):
        num_rows = batch["label"].shape[0]
        if num_rows > self.max_row_bucket:
            raise DMLCError(
                f"SparseRankingModel: row bucket {num_rows} exceeds "
                f"max_row_bucket={self.max_row_bucket}, the reference's "
                "limit for its [n, n] pair intermediates "
                f"(~{num_rows * num_rows * 4 / 1e9:.1f} GB each there); use "
                "a smaller row_bucket in the batch iterator, or raise "
                "max_row_bucket explicitly")
        return pair_sums_autograd(self(batch), batch["label"], batch["qid"],
                                  batch["weight"])

    def pairwise_accuracy(self, batch: Dict[str, Any]) -> float:
        """Fraction of preference pairs the scorer orders correctly
        (host-side, as the reference's; strict inequality, ties count as
        wrong). The pairs are those of the loss's pair weights."""
        self.validate_batch(batch)
        with torch.no_grad():
            m = self(batch).cpu()
        pw = pair_weights_plain(*(torch.as_tensor(batch[k]).cpu()
                                  for k in ("label", "qid", "weight")))
        correct = (m[:, None] > m[None, :]) * pw
        total = pw.sum()
        return float(correct.sum() / total) if total > 0 else float("nan")
