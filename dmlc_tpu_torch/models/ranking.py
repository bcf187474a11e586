"""Pairwise ranking (RankNet) over padded CSR batches, the consumer of the
libsvm ``qid`` column.

Counterpart of ``dmlc_tpu/models/ranking.py``. Scores are
``m_i = w·x_i + b`` (the CSR SpMV, kernel K1 on the card, gradient K2;
on a sharded batch K2 once for all of a process's parts);
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

from typing import Any, Dict, List

import torch
from torch import nn

from dmlc_tpu_torch.models.common import SparseModelBase, _weighted_mean
from dmlc_tpu_torch.ops.csr import parts_spmv, segment_spmv
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

    def _margin_terms(self, batch: Dict[str, Any]) -> List[torch.Tensor]:
        return [segment_spmv(batch["offset"], batch["index"],
                             batch["value"], self.w,
                             num_rows=batch["label"].shape[0])]

    def _parts_margin_terms(self, batch: Dict[str, Any]
                            ) -> List[torch.Tensor]:
        return [parts_spmv(batch["offset"], batch["index"], batch["value"],
                           self.w)]

    def _pair_sums(self, margins: torch.Tensor, batch: Dict[str, Any]):
        """(loss sum, weight sum) of one part's pairs through K7, from
        its margins."""
        return pair_sums_autograd(margins, batch["label"], batch["qid"],
                                  batch["weight"])

    def _objective(self, batch: Dict[str, Any], mesh=None,
                   backward: bool = False) -> torch.Tensor:
        """The pairwise objective (see ``SparseModelBase._objective``),
        differentiated by autograd through K7. Each part pairs only its
        own rows, as the reference's ``shard_map`` runs it on each
        device's block, and ``max_row_bucket`` applies to a part's rows,
        checked before any launch; on a mesh the parts' margins come from
        one stacked term (``_parts_margin_terms``). The loss and weight
        sums of the parts (and of the group) are summed before
        normalising."""
        num_rows = batch["label"].shape[-1]
        if num_rows > self.max_row_bucket:
            raise DMLCError(
                f"SparseRankingModel: row bucket {num_rows} exceeds "
                f"max_row_bucket={self.max_row_bucket}, the reference's "
                "limit for its [n, n] pair intermediates "
                f"(~{num_rows * num_rows * 4 / 1e9:.1f} GB each there); use "
                "a smaller row_bucket in the batch iterator, or raise "
                "max_row_bucket explicitly")
        if mesh is None:
            lsum, wsum = self._pair_sums(self(batch), batch)
        else:
            margins = self._parts_margin_terms(batch)[0] + self.b
            sums = [self._pair_sums(m, self._part(batch, p))
                    for p, m in enumerate(margins.unbind(0))]
            lsum, wsum = sums[0]
            for ls, ws in sums[1:]:
                lsum, wsum = lsum + ls, wsum + ws
        if mesh is None:
            loss = _weighted_mean(lsum, wsum.detach())
            if backward:
                loss.backward()
            return loss.detach()
        total = self._all_reduce(torch.stack([lsum.detach(), wsum.detach()]),
                                 mesh)
        if backward:
            _weighted_mean(lsum, total[1]).backward()
        return _weighted_mean(total[0], total[1])

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
