"""Shared model math and the SGD scaffolding (counterpart of
``dmlc_tpu/models/common.py``): one definition per formula."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from dmlc_tpu_torch.utils.logging import check

__all__ = ["SparseModelBase", "stable_bce_on_logits"]


def _weighted_mean(lsum: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """lsum / wsum with a grad-safe guard for wsum == 0 (an all-padded
    block: lsum is 0 there too, so 0/1 = 0). NOT max(wsum, 1): clamping
    to 1 would rescale the loss whenever 0 < wsum < 1."""
    denom = torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    return lsum / denom


def stable_bce_on_logits(margins: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Per-row binary cross-entropy on logits, numerically stable.

    Labels may follow the ±1 (libsvm) or {0,1} convention: y = label > 0.

    At a zero margin (every row of the zero-initialised model) the
    gradient follows the reference's subgradients, not σ(0) − y:
    ``jnp.maximum`` splits a tie in half (as ``torch.maximum`` does) and
    ``jnp.abs`` has slope +1 at 0 (``torch.abs`` has 0), so |m| is
    written as a select that takes the +m branch at 0.
    """
    y = (labels > 0).to(torch.float32)
    abs_m = torch.where(margins >= 0, margins, -margins)
    return (torch.maximum(margins, torch.zeros_like(margins))
            - margins * y + torch.log1p(torch.exp(-abs_m)))


class SparseModelBase(nn.Module):
    """The weighted-objective SGD scaffolding shared by the sparse models.

    Subclasses provide ``_BATCH_KEYS`` (the batch columns their objective
    consumes beyond label/weight) and ``_block_objective(batch) ->
    (loss_sum, weight_sum)``. The base defines the normalised weighted
    loss with optional l2 (over every parameter except the bias ``b``)
    and the SGD step.
    """

    _BATCH_KEYS: tuple = ("offset", "index", "value")

    def __init__(self, l2: float = 0.0, learning_rate: float = 0.1):
        super().__init__()
        self.l2 = l2
        self.learning_rate = learning_rate

    def _block_objective(self, batch: Dict[str, Any]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def _l2_term(self) -> torch.Tensor:
        return sum((p ** 2).sum() for name, p in self.named_parameters()
                   if name != "b")

    def _check_columns(self, batch: Dict[str, Any]) -> None:
        missing = [k for k in self._BATCH_KEYS + ("label", "weight")
                   if k not in batch]
        check(not missing,
              f"{type(self).__name__} needs batch column(s) {missing} "
              "that this batch lacks")

    def loss(self, batch: Dict[str, Any]) -> torch.Tensor:
        self._check_columns(batch)
        lsum, wsum = self._block_objective(batch)
        loss = _weighted_mean(lsum, wsum)
        if self.l2:
            loss = loss + self.l2 * self._l2_term()
        return loss

    def train_step(self, batch: Dict[str, Any]) -> torch.Tensor:
        """One SGD step on one batch; returns the loss before the update.

        Unlike the reference's functional ``train_step(params, batch) ->
        (new_params, loss)``, this updates the parameters IN PLACE (under
        ``no_grad``), so the 4 MB weight vector is not copied each step.
        """
        for p in self.parameters():
            p.grad = None
        loss = self.loss(batch)
        loss.backward()
        with torch.no_grad():
            for p in self.parameters():
                p.add_(p.grad, alpha=-self.learning_rate)
        return loss.detach()
