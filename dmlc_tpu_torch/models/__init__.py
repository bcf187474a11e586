"""Learners over padded CSR batches."""

from dmlc_tpu_torch.models.fm import SparseFFMModel, SparseFMModel
from dmlc_tpu_torch.models.linear import SparseLinearModel
from dmlc_tpu_torch.models.ranking import SparseRankingModel

__all__ = ["SparseLinearModel", "SparseFMModel", "SparseFFMModel",
           "SparseRankingModel"]
