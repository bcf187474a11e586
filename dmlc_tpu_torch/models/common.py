"""Shared model math and the SGD scaffolding (counterpart of
``dmlc_tpu/models/common.py``): one definition per formula, and one
definition of the single-device and the data-parallel step."""

from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

from dmlc_tpu_torch.ops import step as step_ops
from dmlc_tpu_torch.ops.step import stable_bce_on_logits
from dmlc_tpu_torch.utils.logging import check

__all__ = ["SparseModelBase", "stable_bce_on_logits"]


def _weighted_mean(lsum: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """lsum / wsum with a grad-safe guard for wsum == 0 (an all-padded
    block: lsum is 0 there too, so 0/1 = 0). NOT max(wsum, 1): clamping
    to 1 would rescale the loss whenever 0 < wsum < 1."""
    denom = torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    return lsum / denom


class SparseModelBase(nn.Module):
    """The weighted-objective SGD scaffolding shared by the sparse models.

    Subclasses provide ``_BATCH_KEYS`` (the batch columns their objective
    consumes beyond label/weight) and ``_margin_terms(batch)``: the margins
    without the bias ``b``, as one or two ``[rows]`` terms, whose sum plus
    ``b`` is ``forward``. ``_parts_margin_terms(batch)`` gives the same
    terms, ``[L, rows]`` each, for this process's L parts of a sharded
    batch; a model whose K1 term takes all the parts at once
    (``ops.csr.parts_spmv``: one K2 launch for them in the backward)
    overrides it. The base's objective, ``_objective``, is the
    weighted logistic loss of those margins, run with its margin gradient
    through kernel K8 (``ops.step``); the ranking model overrides it with
    its pairwise objective.

    The base defines the normalised weighted loss with optional l2 (over
    every parameter except the bias ``b``) and the single-part and
    data-parallel SGD steps, whose update is kernel K9.
    """

    _BATCH_KEYS: tuple = ("offset", "index", "value")

    def __init__(self, l2: float = 0.0, learning_rate: float = 0.1):
        super().__init__()
        self.l2 = l2
        self.learning_rate = learning_rate

    def _margin_terms(self, batch: Dict[str, Any]) -> List[torch.Tensor]:
        raise NotImplementedError

    def _parts_margin_terms(self, batch: Dict[str, Any]
                            ) -> List[torch.Tensor]:
        """The margin terms of this process's parts of a sharded batch,
        ``[L, rows]`` each: each part's ``_margin_terms``, stacked."""
        return [torch.stack(ts) for ts in zip(*(
            self._margin_terms(self._part(batch, p))
            for p in range(batch["label"].shape[0])))]

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Margins for one flat padded CSR batch."""
        terms = self._margin_terms(batch)
        margins = terms[0]
        for t in terms[1:]:
            margins = margins + t
        return margins + self.b

    def _objective(self, batch: Dict[str, Any], mesh=None,
                   backward: bool = False) -> torch.Tensor:
        """The loss of ``batch`` without the l2 term: of one part (flat
        ``[rows]`` columns) where ``mesh`` is None, else of this process's
        parts (``[L, rows]``) normalised by the weight of the whole group's
        batch (its all-reduce). With ``backward``, also sets every
        parameter's ``.grad`` to this process's gradient of that loss.

        The weighted logistic loss of the margin terms through K8: on one
        part one launch gives the loss, the margin gradient g and ``b``'s
        gradient Σ g; on a mesh the terms are stacked over the parts, K8's
        first launch sums (lsum, wsum), which is all-reduced, and its
        second reads the group's W on the device. Autograd sends g back
        through each term's kernels: on a mesh K2 once for all the
        parts (``_parts_margin_terms``)."""
        if mesh is None:
            terms = self._margin_terms(batch)
        else:
            terms = self._parts_margin_terms(batch)
        args = ([t.detach() for t in terms], self.b.detach(),
                batch["label"], batch["weight"])
        if mesh is None:
            loss, g, gb = step_ops.logistic_step(*args)
        else:
            total = self._all_reduce(step_ops.logistic_sums(*args), mesh)
            loss, g, gb = step_ops.logistic_grad(*args, total)
        if backward:
            torch.autograd.backward(terms, [g] * len(terms))
            self.b.grad = gb
        return loss

    def _l2_term(self) -> torch.Tensor:
        return sum((p ** 2).sum() for name, p in self.named_parameters()
                   if name != "b")

    def _check_columns(self, batch: Dict[str, Any]) -> None:
        missing = [k for k in self._BATCH_KEYS + ("label", "weight")
                   if k not in batch]
        check(not missing,
              f"{type(self).__name__} needs batch column(s) {missing} "
              "that this batch lacks")

    def _with_l2(self, loss: torch.Tensor) -> torch.Tensor:
        return loss + self.l2 * self._l2_term() if self.l2 else loss

    def loss(self, batch: Dict[str, Any]) -> torch.Tensor:
        """The loss of one flat batch, with the l2 term (a value)."""
        self._check_columns(batch)
        with torch.no_grad():
            return self._with_l2(self._objective(batch))

    def _sgd(self, loss: torch.Tensor) -> None:
        """K9 over every parameter, l2 on all but ``b``; adds the loss's l2
        term (of the parameters before the update) to ``loss``."""
        names, params = zip(*self.named_parameters())
        step_ops.sgd_update(params, [p.grad for p in params],
                            [n != "b" for n in names], self.learning_rate,
                            self.l2, loss)

    def train_step(self, batch: Dict[str, Any]) -> torch.Tensor:
        """One SGD step on one batch; returns the loss before the update.

        Unlike the reference's functional ``train_step(params, batch) ->
        (new_params, loss)``, this updates the parameters IN PLACE, so the
        4 MB weight vector is not copied each step. The logistic models'
        objective, its margin gradient and ``b``'s gradient are one K8
        launch; the update and the loss's l2 term are one K9 launch.
        """
        self._check_columns(batch)
        for p in self.parameters():
            p.grad = None
        loss = self._objective(batch, backward=True)
        self._sgd(loss)
        return loss

    # -- data parallel (parallel.sharded layout: [L, ...] columns)

    @staticmethod
    def _all_reduce(t: torch.Tensor, mesh) -> torch.Tensor:
        """``t`` summed in place over the mesh's group (an all-reduce
        whenever the mesh has a group, world 1 included)."""
        if mesh.group is None:
            return t
        import torch.distributed as dist
        from dmlc_tpu_torch.parallel.sharded import collective_device
        reduced = t.to(collective_device(mesh))
        dist.all_reduce(reduced, group=mesh.group)
        if reduced is not t:
            t.copy_(reduced)
        return t

    @staticmethod
    def _part(batch: Dict[str, Any], p: int) -> Dict[str, Any]:
        return {k: v[p] for k, v in batch.items()}

    def global_loss(self, batch: Dict[str, Any], mesh) -> torch.Tensor:
        """The loss of a sharded batch over the whole group (counterpart
        of the reference's ``global_loss_fn``): the loss and weight sums
        of every part of every process summed before normalising, so the
        mean weights every datum once, not every part; plus the l2 term
        once. A value, not differentiable through the all-reduce."""
        self._check_columns(batch)
        with torch.no_grad():
            return self._with_l2(self._objective(batch, mesh))

    def make_sharded_train_step(self, mesh, axis: str = "data"):
        """The data-parallel SGD step over ``mesh``'s ``axis`` (counterpart
        of the reference's ``make_sharded_train_step``): ``step(batch) ->
        loss`` on a sharded batch of this process's parts along ``axis``,
        the parameters updated IN PLACE as ``train_step`` does; every
        process of the group must call it on its own parts.

        ``_objective`` gives the group's loss and this process's gradient
        of it; the gradients are all-reduced (SUM), which gives every
        process the gradient of the group's loss; then K9 updates every
        parameter, adding the l2 term once. The loss returned is the
        group's, before the update."""
        check(axis in mesh.axis_names,
              f"axis {axis!r} is not an axis of the mesh, whose axes are "
              f"{mesh.axis_names}")
        parts = len(mesh.local_parts(axis))

        def step(batch: Dict[str, Any]) -> torch.Tensor:
            self._check_columns(batch)
            got = batch["label"].shape[0]
            check(got == parts,
                  f"the batch holds {got} parts, the mesh gives this "
                  f"process {parts} along {axis!r}")
            for p in self.parameters():
                p.grad = None
            loss = self._objective(batch, mesh, backward=True)
            for p in self.parameters():
                self._all_reduce(p.grad, mesh)
            self._sgd(loss)
            return loss

        return step
