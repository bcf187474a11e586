"""Factorization machines (second-order FM and field-aware FFM) over
padded CSR batches.

Counterpart of ``dmlc_tpu/models/fm.py``. The margin of a row is
``b + Σ_i w_i x_i + pair``: the linear term is the CSR SpMV (kernel K1,
gradient K2, ``ops.csr.segment_spmv``), the pair term FM's (Rendle 2010,
the O(nnz·K) identity; kernel K5 forward and backward, ``ops.fm.fm_pair``)
or FFM's (Juan et al. 2016, one K-vector per feature and field, the
partner's field selects it; kernel K6 forward and backward,
``ops.fm.ffm_pair``). Plain FM ignores ``field``. Padded rows carry
weight 0, so they are loss- and gradient-neutral.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from dmlc_tpu_torch.models.common import SparseModelBase
from dmlc_tpu_torch.ops.csr import segment_spmv
from dmlc_tpu_torch.ops.fm import ffm_pair, fm_pair
from dmlc_tpu_torch.utils.logging import check

__all__ = ["SparseFMModel", "SparseFFMModel"]


class _SparseFactorModelBase(SparseModelBase):
    """Factor-model layer over the shared scaffolding: parameters
    ``w[num_features]``, ``b[]`` (zero-initialised, as the reference) and
    ``V`` of ``factor_shape`` per feature, drawn N(0, init_scale²) from
    ``generator`` (a ``torch.Generator``; seed 0 on ``device`` when
    None). Subclasses provide ``_pair(batch)``. ``device`` defaults to
    ``cuda``."""

    def __init__(self, num_features: int, factor_shape: tuple, l2: float,
                 learning_rate: float, init_scale: float, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(l2=l2, learning_rate=learning_rate)
        device = torch.device("cuda" if device is None else device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.num_features = num_features
        self.init_scale = init_scale
        self.w = nn.Parameter(torch.zeros(num_features, device=device))
        self.b = nn.Parameter(torch.zeros((), device=device))
        # small random factors: an all-zero V has zero gradient through
        # the pair term (a saddle), so zero init cannot learn
        V = torch.randn((num_features,) + factor_shape, generator=generator,
                        device=generator.device).mul_(init_scale)
        self.V = nn.Parameter(V.to(device))

    def _pair(self, batch: Dict[str, Any]) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Margins for one flat padded CSR batch."""
        linear = segment_spmv(batch["offset"], batch["index"],
                              batch["value"], self.w,
                              num_rows=batch["label"].shape[0])
        return linear + self._pair(batch) + self.b

    def predict_proba(self, batch: Dict[str, Any]) -> torch.Tensor:
        return torch.sigmoid(self(batch))


class SparseFMModel(_SparseFactorModelBase):
    """Second-order FM with logistic loss (labels ±1 or {0,1});
    V [num_features, num_factors]."""

    def __init__(self, num_features: int, num_factors: int = 8,
                 l2: float = 0.0, learning_rate: float = 0.1,
                 init_scale: float = 0.01, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_features, (num_factors,), l2, learning_rate,
                         init_scale, device, generator)
        self.num_factors = num_factors

    def _pair(self, batch):
        return fm_pair(batch["offset"], batch["index"], batch["value"],
                       self.V)


class SparseFFMModel(_SparseFactorModelBase):
    """Field-aware factorization machine with logistic loss, the
    consumer of the libfm ``field`` column; V [num_features, num_fields,
    num_factors].

    The forward CLIPS out-of-range field ids, as the reference's, which
    would silently merge a misconfigured field space into the last
    field: call ``validate_batch`` once per data source to turn that
    into an error."""

    _BATCH_KEYS = ("offset", "index", "value", "field")

    def __init__(self, num_features: int, num_fields: int,
                 num_factors: int = 4, l2: float = 0.0,
                 learning_rate: float = 0.1, init_scale: float = 0.05,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(num_features, (num_fields, num_factors), l2,
                         learning_rate, init_scale, device, generator)
        self.num_fields = num_fields
        self.num_factors = num_factors

    def validate_batch(self, batch: Dict[str, Any]) -> None:
        """Host-side guard: every field id must be in [0, num_fields)."""
        f = torch.as_tensor(batch["field"])
        mn, mx = (int(f.min()), int(f.max())) if f.numel() else (0, 0)
        check(0 <= mn and mx < self.num_fields,
              f"FFM batch carries field ids [{mn}, {mx}] but the model "
              f"was built with num_fields={self.num_fields} — the forward "
              "would silently clip them; fix num_fields or the data")

    def _pair(self, batch):
        return ffm_pair(batch["offset"], batch["index"], batch["value"],
                        batch["field"], self.V)
