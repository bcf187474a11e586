"""Entry points of the port's checks: the single-device loss and the
data-parallel dry run.

Counterpart of the repo root's ``__graft_entry__.py``, driven by the
port:

- ``entry(device)``: the loss of the flagship ``SparseLinearModel`` on
  one padded CSR batch (the framework's canonical data layout);
- ``dryrun_multichip(n_parts, device, group)``: a :class:`~dmlc_tpu_torch.
  parallel.sharded.Mesh` of ``n_parts`` parts on the data axis, the full
  data-parallel SGD step over sharded CSR batches fed by the real
  ingest stack — an on-disk libsvm file through Parser shards →
  ShardedRowBlockIter (pad → stack → copy to the device) — trained for
  5 tiny epochs with a loss-descent check, memory replay of epoch 3, a
  parity check against one flat golden step on the same batches, and
  for even ``n_parts >= 4`` a 2-D (data × model) phase whose weight
  vector is held as 2 slices over the model axis.

The mesh's parts all live on one device of this process (a card, or the
CPU); with ``group`` the step all-reduces over it (NCCL on the card).
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip", "write_dryrun_corpus"]

NUM_FEATURES = 64
ROW_BUCKET, NNZ_BUCKET = 16, 128
LEARNING_RATE = 0.05
# the dry run's parity tolerance, as the reference's
RTOL, ATOL = 1e-5, 1e-7


def _synthetic_batch(num_rows, nnz, num_features, seed=0):
    from dmlc_tpu_torch.data.rowblock import RowBlock
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, max(2, nnz // max(num_rows, 1)), size=num_rows)
    while lens.sum() > nnz:
        lens[rng.randint(num_rows)] -= 1
    offset = np.zeros(num_rows + 1, np.int64)
    offset[1:] = np.cumsum(lens)
    z = int(offset[-1])
    index = rng.randint(0, num_features, z).astype(np.uint32)
    value = rng.rand(z).astype(np.float32)
    # labels from a hidden linear rule so one SGD step provably helps
    w_true = np.random.RandomState(7).randn(num_features).astype(np.float32)
    margins = np.zeros(num_rows, np.float32)
    for i in range(num_rows):
        lo, hi = offset[i], offset[i + 1]
        margins[i] = (value[lo:hi] * w_true[index[lo:hi]]).sum()
    label = np.where(margins > np.median(margins), 1.0, -1.0).astype(
        np.float32)
    return RowBlock(offset=offset, label=label, index=index, value=value)


def entry(device=None):
    """(fn, args): ``fn(*args)`` is the loss of SparseLinearModel(1024)
    at its zero init on one padded batch of 256 rows, on ``device``
    (``cuda`` by default)."""
    from dmlc_tpu_torch.data.padding import pad_to_bucket
    from dmlc_tpu_torch.models import SparseLinearModel
    device = torch.device("cuda" if device is None else device)
    num_features = 1024
    model = SparseLinearModel(num_features, device=device)
    block = _synthetic_batch(num_rows=256, nnz=2048,
                             num_features=num_features)
    batch = {k: torch.from_numpy(np.asarray(v)).to(device)
             for k, v in pad_to_bucket(block, row_bucket=256,
                                       nnz_bucket=2048).items()}
    return model.loss, (batch,)


def write_dryrun_corpus(path: str, n_parts: int) -> None:
    """The dry run's on-disk dataset, as the reference writes it: 40
    rows a part of 2-6 distinct sorted features below 64 with uniform
    values, labelled by a hidden linear rule (seeds 0 and 7)."""
    rng = np.random.RandomState(0)
    w_true = np.random.RandomState(7).randn(NUM_FEATURES)
    with open(path, "w") as f:
        for _ in range(40 * n_parts):
            idx = np.sort(rng.choice(NUM_FEATURES, rng.randint(2, 7),
                                     replace=False))
            vals = rng.rand(len(idx))
            y = 1 if (vals * w_true[idx]).sum() > 0 else 0
            f.write(f"{y} " + " ".join(
                f"{j}:{v:.4f}" for j, v in zip(idx, vals)) + "\n")


def _golden_loss(w, b, batch):
    """The dry run's loss over the ``[D, ...]`` parts of ``batch`` as one
    flat computation on one device, written out here (not the model's
    sharded step): each part's margins by ``segment_spmv``, the stable
    logistic loss (|m| as a select, as ``stable_bce_on_logits`` writes
    it, so that the zero init takes the reference's subgradients), Σ
    over parts of the weighted sums, then their ratio with the weight
    sum clamped at 1, as the reference's golden."""
    from dmlc_tpu_torch.ops.csr import segment_spmv
    ls = ws = 0.0
    for p in range(batch["label"].shape[0]):
        margins = segment_spmv(batch["offset"][p], batch["index"][p],
                               batch["value"][p], w,
                               num_rows=ROW_BUCKET) + b
        y = (batch["label"][p] > 0).to(torch.float32)
        abs_m = torch.where(margins >= 0, margins, -margins)
        per_row = (torch.maximum(margins, torch.zeros_like(margins))
                   - margins * y + torch.log1p(torch.exp(-abs_m)))
        ls = ls + (per_row * batch["weight"][p]).sum()
        ws = ws + batch["weight"][p].sum()
    return ls / torch.clamp(ws, min=1.0)


def _golden_step(params, batch):
    loss = _golden_loss(params["w"], params["b"], batch)
    gw, gb = torch.autograd.grad(loss, (params["w"], params["b"]))
    with torch.no_grad():
        params["w"] -= LEARNING_RATE * gw
        params["b"] -= LEARNING_RATE * gb
    return loss.detach()


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:12]


def dryrun_multichip(n_parts: int, device=None, group=None
                     ) -> Dict[str, Any]:
    """The data-parallel dry run over a mesh of ``n_parts`` parts on
    ``device`` (``cuda`` by default), all-reducing over ``group`` when
    one is given. Raises AssertionError on any failed check; returns
    the final parameters and the figures it printed."""
    from dmlc_tpu_torch.models import SparseLinearModel
    from dmlc_tpu_torch.parallel.sharded import Mesh, ShardedRowBlockIter
    device = torch.device("cuda" if device is None else device)
    mesh = Mesh((n_parts,), ("data",), group=group, device=device)
    model = SparseLinearModel(NUM_FEATURES, learning_rate=LEARNING_RATE,
                              device=device)
    fd, path = tempfile.mkstemp(suffix=".libsvm")
    os.close(fd)
    its = []
    try:
        write_dryrun_corpus(path, n_parts)
        it = ShardedRowBlockIter(path, mesh, format="libsvm",
                                 row_bucket=ROW_BUCKET,
                                 nnz_bucket=NNZ_BUCKET)
        its.append(it)
        batches = list(it)  # parse → pad → stack → [L, ...] on the device
        assert batches, "ingest produced no batches"
        step = model.make_sharded_train_step(mesh)
        l0 = float(model.global_loss(batches[0], mesh))
        for _ in range(5):  # one-step descent is noisy; 5 epochs are not
            for batch in batches:
                step(batch)
        # measured on the SAME batch as l0 so the comparison is meaningful
        l5 = float(model.global_loss(batches[0], mesh))
        assert np.isfinite(l0) and np.isfinite(l5), (l0, l5)
        assert l5 < l0, f"loss must decrease over 5 epochs: {l0} -> {l5}"

        # steady-epoch replay through the SAME iterator: epoch 2
        # re-parses and tees (single-process "auto"), epoch 3 serves the
        # retained rounds from memory — batches identical to epoch 1
        e2 = list(it)
        e3 = list(it)
        assert len(e2) == len(e3) == len(batches), (
            len(batches), len(e2), len(e3))
        assert it.replay_epochs >= 1, "steady replay never engaged"
        assert it.replay_tier == "memory", it.replay_tier
        for a, b in zip(batches, e3):
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), k

        # parity: replay the SAME batches through one flat golden step on
        # one device. Any wrong all-reduce or mis-assigned part gives an
        # O(1) parameter error; bitwise equality is reported besides
        # (the sums may run in other orders)
        gparams = {"w": torch.zeros(NUM_FEATURES, device=device,
                                    requires_grad=True),
                   "b": torch.zeros((), device=device, requires_grad=True)}
        for _ in range(5):
            for batch in batches:
                _golden_step(gparams, batch)
        # one more step on EACH side, so the comparison also covers a
        # fresh gradient at the converged point
        _golden_step(gparams, batches[0])
        step(batches[0])
        w_mesh, w_gold = model.w.detach(), gparams["w"].detach()
        torch.testing.assert_close(w_mesh, w_gold, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(model.b.detach(), gparams["b"].detach(),
                                   rtol=RTOL, atol=ATOL)
        dm, dg = _digest(w_mesh), _digest(w_gold)

        # the 2-D (data x model) phase: the weight vector held as M = 2
        # slices over the model axis, gathered before K1; K2's gradient
        # splits back to the slices. Loss and gradients must match the
        # unsharded computation on the same batch
        tp_note = ""
        if n_parts >= 4 and n_parts % 2 == 0:
            m = 2
            mesh2 = Mesh((n_parts // 2, m), ("data", "model"), group=group,
                         device=device)
            it2 = ShardedRowBlockIter(path, mesh2, format="libsvm",
                                      row_bucket=ROW_BUCKET,
                                      nnz_bucket=NNZ_BUCKET)
            its.append(it2)
            b2 = next(iter(it2))
            w0 = torch.from_numpy(np.random.RandomState(11).randn(
                NUM_FEATURES).astype(np.float32)).to(device)
            slices = [s.clone().requires_grad_(True)
                      for s in w0.chunk(mesh2.parts("model"))]
            b_tp = torch.tensor(0.25, device=device, requires_grad=True)
            l_tp = _golden_loss(torch.cat(slices), b_tp, b2)
            grads = torch.autograd.grad(l_tp, slices + [b_tp])
            gw, gb = torch.cat(grads[:m]), grads[m]
            w_ref = w0.clone().requires_grad_(True)
            b_ref = torch.tensor(0.25, device=device, requires_grad=True)
            l_ref = _golden_loss(w_ref, b_ref, b2)
            gw_ref, gb_ref = torch.autograd.grad(l_ref, (w_ref, b_ref))
            for got, want in ((l_tp, l_ref), (gw, gw_ref), (gb, gb_ref)):
                torch.testing.assert_close(got.detach(), want.detach(),
                                           rtol=RTOL, atol=ATOL)
            tp_note = (f"; model-axis phase OK (2-D {n_parts // 2}x{m} "
                       f"data*model mesh, w held as {m} slices, loss+grad "
                       f"parity {float(l_tp.detach()):.4f})")
        print(f"dryrun_multichip({n_parts}) on {device}: loss {l0:.4f} -> "
              f"{l5:.4f} OK ({len(batches)} batches through the "
              f"file→mesh stack); steady replay OK ({it.replay_epochs} "
              f"epoch(s) served from retained rounds, batches identical); "
              f"1-device parity {'BITWISE' if dm == dg else 'allclose'} "
              f"(mesh={dm} golden={dg}){tp_note}", flush=True)
        return {"w": w_mesh.cpu().numpy(),
                "b": float(model.b.detach()), "loss0": l0, "loss5": l5,
                "batches": len(batches), "replay_epochs": it.replay_epochs}
    finally:
        for i in its:
            i.close()
        os.unlink(path)
