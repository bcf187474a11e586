"""Shared model math and the SGD scaffolding (counterpart of
``dmlc_tpu/models/common.py``): one definition per formula, and one
definition of the single-device and the data-parallel step."""

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
    consumes beyond label/weight) and ``forward(batch) -> margins``; the
    objective of a block, ``_block_objective(batch) -> (loss_sum,
    weight_sum)``, is the weighted logistic loss of those margins unless a
    subclass overrides it. The base defines the normalised weighted loss
    with optional l2 (over every parameter except the bias ``b``) and the
    SGD step.
    """

    _BATCH_KEYS: tuple = ("offset", "index", "value")

    def __init__(self, l2: float = 0.0, learning_rate: float = 0.1):
        super().__init__()
        self.l2 = l2
        self.learning_rate = learning_rate

    def _block_objective(self, batch: Dict[str, Any]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        per_row = stable_bce_on_logits(self(batch), batch["label"])
        w = batch["weight"]
        return (per_row * w).sum(), w.sum()

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

    # -- data parallel (parallel.sharded layout: [L, ...] columns)

    def _sharded_sums(self, batch: Dict[str, Any], mesh
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Σ loss sums, Σ weight sums) over this process's L parts, and
        the same pair summed over the mesh's group (detached; an
        all-reduce whenever the mesh has a group, world 1 included).

        Each part runs the model's own objective on its block, as the
        reference's ``shard_map`` runs it on each device's: the ranking
        model pairs rows only inside a part, and its ``max_row_bucket``
        applies to a part's rows."""
        self._check_columns(batch)
        lsum = wsum = None
        for p in range(batch["label"].shape[0]):
            ls, ws = self._block_objective({k: v[p] for k, v in batch.items()})
            lsum = ls if lsum is None else lsum + ls
            wsum = ws if wsum is None else wsum + ws
        total = torch.stack([lsum.detach(), wsum.detach()])
        if mesh.group is not None:
            import torch.distributed as dist
            from dmlc_tpu_torch.parallel.sharded import collective_device
            dev = collective_device(mesh)
            reduced = total.to(dev)
            dist.all_reduce(reduced, group=mesh.group)
            total = reduced.to(total.device)
        return lsum, total

    def _global_loss_value(self, total: torch.Tensor) -> torch.Tensor:
        """The global loss from the group's (Σ lsum, Σ wsum): the
        weighted mean, plus the l2 term once."""
        loss = _weighted_mean(total[0], total[1])
        if self.l2:
            loss = loss + self.l2 * self._l2_term()
        return loss

    def global_loss(self, batch: Dict[str, Any], mesh) -> torch.Tensor:
        """The loss of a sharded batch over the whole group (counterpart
        of the reference's ``global_loss_fn``): the loss and weight sums
        of every part of every process summed before normalising, so the
        mean weights every datum once, not every part; plus the l2 term
        once. A value, not differentiable through the all-reduce."""
        with torch.no_grad():
            return self._global_loss_value(
                self._sharded_sums(batch, mesh)[1])

    def make_sharded_train_step(self, mesh):
        """The data-parallel SGD step over ``mesh`` (counterpart of the
        reference's ``make_sharded_train_step``): ``step(batch) -> loss``
        on a sharded batch, the parameters updated IN PLACE as
        ``train_step`` does; every process of the group must call it on
        its own parts.

        The per-part (lsum, wsum) are summed over the process's parts
        and all-reduced; each process backpropagates its ``lsum / W`` (W
        the group's weight sum, guarded as the flat loss guards it) and
        the gradients are all-reduced (SUM), which gives every process
        the gradient of the group's loss; then the l2 term's gradient,
        ``2·l2·p`` for every parameter but ``b``, is added once. The
        loss returned is the group's, before the update."""
        def step(batch: Dict[str, Any]) -> torch.Tensor:
            params = list(self.named_parameters())
            for _, p in params:
                p.grad = None
            lsum, total = self._sharded_sums(batch, mesh)
            denom = torch.where(total[1] > 0, total[1],
                                torch.ones_like(total[1]))
            (lsum / denom).backward()
            if mesh.group is not None:
                import torch.distributed as dist
                from dmlc_tpu_torch.parallel.sharded import (
                    collective_device,
                )
                dev = collective_device(mesh)
                for _, p in params:
                    g = p.grad.to(dev)
                    dist.all_reduce(g, group=mesh.group)
                    if g is not p.grad:
                        p.grad.copy_(g)
            with torch.no_grad():
                loss = self._global_loss_value(total)
                for name, p in params:
                    if self.l2 and name != "b":
                        p.grad.add_(p, alpha=2 * self.l2)
                    p.add_(p.grad, alpha=-self.learning_rate)
            return loss.detach()

        return step
