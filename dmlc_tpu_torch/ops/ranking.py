"""The pairwise ranking loss (kernel K7, forward and backward) and its
plain versions.

Counterpart of ``dmlc_tpu/models/ranking.py:51`` ``_pair_weights`` and
``:64`` ``_pair_sums``, and of their gradient in the margins, which XLA
compiled from jnp there. Here each is a CUDA kernel written by hand
(``csrc/ranking.cu``) with a plain PyTorch version of the same function
beside it:

- ``pair_weights_plain``: pw[i,j] = w_i·w_j where qid_i == qid_j ≥ 0 and
  label_i > label_j, else 0 (``[n, n]``; also what ``pairwise_accuracy``
  counts);
- K7 ``pair_sums``:      (lsum, wsum) = (Σ_ij softplus(−(m_i − m_j))·pw[i,j],
  Σ_ij pw[i,j]), and the tile table that K7 backward reads;
- K7 ``pair_sums_grad``: g_i = Σ_j s·pw[j,i]·sp′(m_i − m_j)
  − Σ_j s·pw[i,j]·sp′(m_j − m_i), the gradient of s·lsum in the margins.

``pair_sums_autograd`` pairs them in a ``torch.autograd.Function``
returning (lsum, wsum), differentiable in the margins only: wsum depends
on no parameter. As in ``ops/csr.py``, a wrapper runs the plain version
only when its tensors lie on the CPU, and for CUDA tensors launches its
kernel or raises; each wrapper counts its launches in ``.launches``.

Every pair counts, as in the reference, so a NaN or infinite margin
anywhere makes lsum NaN, and the gradient is NaN where ``jax.vjp`` puts
it. The kernels evaluate only the pairs of the tiles that can hold a
weighted pair when every unweighted pair adds exactly ±0 (finite margins
and weights, a finite spread of the margins and a finite max|w|², a
finite s), and every pair otherwise: ``csrc/ranking.cu`` states the rule.
The forward's tile table carries that decision, on the device, to the
backward, which on the card needs it. softplus is ``jax.nn.softplus`` (``logaddexp(x, 0)``), not
``torch.nn.functional.softplus`` (whose threshold of 20 differs); sp′ is
the derivative that jax's ``logaddexp`` jvp forms, ``exp(x −
softplus(x))`` with +inf read as 0. The plain versions materialise the
``[n, n]`` pair arrays that the kernels do not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dmlc_tpu_torch.ops.kernels import count, launch
from dmlc_tpu_torch.utils.logging import check

__all__ = ["pair_weights_plain", "pair_sums_plain", "pair_sums_grad_plain",
           "pair_sums", "pair_sums_grad", "pair_sums_autograd"]

# kTile of csrc/ranking.cu: the documents of a tile, which size the table.
_TILE = 128


def table_size(n: int) -> int:
    """int64 entries of the tile table of n documents: the safe flag, the
    forward's count of finished blocks and each tile's valid-qid
    interval."""
    return 2 + 2 * ((n + _TILE - 1) // _TILE)


def pair_weights_plain(label: torch.Tensor, qid: torch.Tensor,
                       weight: torch.Tensor) -> torch.Tensor:
    """[n, n] preference-pair weights, the one definition of which pairs
    exist and what they weigh."""
    valid = qid >= 0
    same = ((qid[:, None] == qid[None, :])
            & valid[:, None] & valid[None, :])
    pref = label[:, None] > label[None, :]
    return (weight[:, None] * weight[None, :]
            * (same & pref).to(torch.float32))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: x where x is NaN, else max(x, 0) + log1p(exp(−|x|))."""
    sp = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))
    return torch.where(torch.isnan(x), x, sp)


def _softplus_grad(x: torch.Tensor) -> torch.Tensor:
    """d softplus / dx as jax's logaddexp jvp forms it."""
    sp = _softplus(x)
    return torch.exp(torch.where(x == float("inf"), 0.0, x)
                     - torch.where(sp == float("inf"), 0.0, sp))


def pair_sums_plain(margins: torch.Tensor, label: torch.Tensor,
                    qid: torch.Tensor, weight: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7 forward: the reference's [n, n] arrays."""
    pw = pair_weights_plain(label, qid, weight)
    diff = margins[:, None] - margins[None, :]
    return (_softplus(-diff) * pw).sum(), pw.sum()


def pair_sums_grad_plain(margins: torch.Tensor, label: torch.Tensor,
                         qid: torch.Tensor, weight: torch.Tensor,
                         s: torch.Tensor) -> torch.Tensor:
    """Plain version of K7 backward: the cotangent s of lsum pulled back
    through the reference's [n, n] arrays to the margins."""
    pw = pair_weights_plain(label, qid, weight)
    x = -(margins[:, None] - margins[None, :])
    ct = (s * pw) * _softplus_grad(x)  # the cotangent of x[i, j]
    # x[i, j] = m_j − m_i: −ct to m_i (its row), +ct to m_j (its column)
    return ct.sum(0) - ct.sum(1)


def _check(margins, label, qid, weight, s=None):
    """Checks a call's tensors; returns whether to launch the kernel."""
    n = margins.numel()
    for name, t in (("margins", margins), ("label", label),
                    ("weight", weight)):
        check(t.dtype == torch.float32 and tuple(t.shape) == (n,),
              f"{name} must be float32 [{n}], got {t.dtype} "
              f"{tuple(t.shape)}")
    check(qid.dtype == torch.int64 and tuple(qid.shape) == (n,),
          f"qid must be int64 [{n}], got {qid.dtype} {tuple(qid.shape)}")
    tensors = [margins, label, qid, weight]
    if s is not None:
        check(s.dtype == torch.float32 and s.numel() == 1,
              f"s must be a float32 scalar, got {s.dtype} "
              f"{tuple(s.shape)}")
        tensors.append(s)
    devices = {t.device for t in tensors}
    check(len(devices) == 1, f"the ranking tensors must share one device, "
          f"got {sorted(str(d) for d in devices)}")
    if margins.device.type == "cpu":
        return False
    check(margins.is_cuda,
          f"the ranking kernels run on cuda or cpu, got {margins.device}")
    for t in tensors:
        check(t.is_contiguous(), "the ranking kernels need contiguous "
              "tensors")
    return True


def pair_sums(margins: torch.Tensor, label: torch.Tensor, qid: torch.Tensor,
              weight: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """K7 forward: (lsum, wsum, the tile table for ``pair_sums_grad``):
    two float32 scalars, and the table, None on the CPU."""
    if not _check(margins, label, qid, weight):
        return pair_sums_plain(margins, label, qid, weight) + (None,)
    n = margins.numel()
    row_sums = torch.empty(2 * n, dtype=torch.float32, device=margins.device)
    table = torch.empty(table_size(n), dtype=torch.int64,
                        device=margins.device)
    lsum = torch.empty((), dtype=torch.float32, device=margins.device)
    wsum = torch.empty((), dtype=torch.float32, device=margins.device)
    launch("dmlc_pair_sums_fwd", margins.device, margins.data_ptr(),
           label.data_ptr(), qid.data_ptr(), weight.data_ptr(), n,
           row_sums.data_ptr(), table.data_ptr(), lsum.data_ptr(),
           wsum.data_ptr())
    count(pair_sums)
    return lsum, wsum, table


def pair_sums_grad(margins: torch.Tensor, label: torch.Tensor,
                   qid: torch.Tensor, weight: torch.Tensor,
                   s: torch.Tensor,
                   table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7 backward: g [n], the gradient of s·lsum in the margins, for the
    cotangent s (a float32 scalar on the margins' device). On the card
    ``table`` is the tile table that ``pair_sums`` returned on the same
    inputs; the CPU takes none."""
    if not _check(margins, label, qid, weight, s):
        check(table is None, "the plain K7 backward takes no tile table")
        return pair_sums_grad_plain(margins, label, qid, weight, s)
    n = margins.numel()
    check(table is not None and table.dtype == torch.int64
          and tuple(table.shape) == (table_size(n),)
          and table.device == margins.device,
          f"K7 backward needs the forward's tile table, int64 "
          f"[{table_size(n)}] on {margins.device}, got "
          + ("none" if table is None else f"{table.dtype} "
             f"{tuple(table.shape)} on {table.device}"))
    g = torch.empty_like(margins)
    launch("dmlc_pair_sums_bwd", margins.device, margins.data_ptr(),
           label.data_ptr(), qid.data_ptr(), weight.data_ptr(),
           s.contiguous().data_ptr(), n, table.data_ptr(), g.data_ptr())
    count(pair_sums_grad)
    return g


pair_sums.launches = 0
pair_sums_grad.launches = 0


class _PairSums(torch.autograd.Function):
    """(lsum, wsum) with K7 forward and K7 backward, which reads the
    forward's tile table; the gradient flows to the margins only (labels,
    qids and weights are data)."""

    @staticmethod
    def forward(ctx, margins, label, qid, weight):
        lsum, wsum, table = pair_sums(margins, label, qid, weight)
        ctx.save_for_backward(margins, label, qid, weight, table)
        ctx.mark_non_differentiable(wsum)
        return lsum, wsum

    @staticmethod
    def backward(ctx, g_lsum, g_wsum):
        margins, label, qid, weight, table = ctx.saved_tensors
        g = None
        if ctx.needs_input_grad[0]:
            g = pair_sums_grad(margins, label, qid, weight,
                               g_lsum.reshape(()).contiguous(), table)
        return g, None, None, None


def pair_sums_autograd(margins: torch.Tensor, label: torch.Tensor,
                       qid: torch.Tensor, weight: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lsum, wsum) of one batch, differentiable in ``margins``."""
    return _PairSums.apply(margins, label, qid, weight)
