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

The mesh's parts of this process all live on its one device (a card,
or the CPU); with ``group`` the step all-reduces over it (NCCL on the
card, a card a rank). At a world of W > 1 each rank holds L = D / W
parts, and the golden replays the reference's global ``[D, ...]``
batches, gathered from every rank in part order.

``python -m dmlc_tpu_torch.graft`` is the twin of ``python
__graft_entry__.py``: ``entry()`` once, then the dry run (see
:func:`main`).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip", "write_dryrun_corpus", "main"]

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


def _say(line: str) -> None:
    """``line`` to stdout in one write: the ranks of a gang share the
    launcher's stdout, and ``print`` writes the text and its newline
    apart, so two ranks' lines could interleave (a stdout with no file
    descriptor, as a test's capture, takes ``print``)."""
    sys.stdout.flush()
    try:
        fd = sys.stdout.fileno()
    except (AttributeError, OSError, ValueError):  # a captured stdout
        print(line, flush=True)
        return
    os.write(fd, (line + "\n").encode())


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:12]


def _all_same(text: str, mesh) -> List[bytes]:
    """Every rank's sha256 of ``text``, all-gathered over ``mesh.group``
    (in rank order)."""
    import torch.distributed as dist
    from dmlc_tpu_torch.parallel.sharded import collective_device
    mine = torch.frombuffer(bytearray(hashlib.sha256(
        text.encode()).digest()), dtype=torch.uint8).to(
        collective_device(mesh))
    bufs = [torch.empty_like(mine) for _ in range(mesh.world)]
    dist.all_gather(bufs, mine, group=mesh.group)
    return [bytes(b.cpu().numpy()) for b in bufs]


def _global_batches(batches: list, mesh) -> list:
    """The reference's global ``[D, ...]`` batches from this rank's
    ``[L, ...]`` ones: every rank's arrays all-gathered over
    ``mesh.group`` (CUDA tensors under NCCL, CPU ones under gloo) and
    joined in rank order, which is part order (rank r owns parts
    ``[r·L, (r+1)·L)``). The buckets are fixed, so every rank's keys,
    shapes and dtypes must agree: that is checked first, by digest."""
    if mesh.group is None or mesh.world == 1:
        return batches
    import torch.distributed as dist
    from dmlc_tpu_torch.parallel.sharded import collective_device
    layout = repr([(k, tuple(b[k].shape), str(b[k].dtype))
                   for b in batches for k in sorted(b)])
    got = _all_same(layout, mesh)
    assert len(set(got)) == 1, (
        f"rank {mesh.rank}: the ranks' batch layouts differ ({layout})")
    cdev = collective_device(mesh)
    out = []
    for b in batches:
        g = {}
        for k in sorted(b):
            t = b[k].contiguous()
            # as bytes: NCCL and gloo carry uint8 whatever the column's
            # dtype (the index is u32 or u64)
            mine = t.view(torch.uint8).to(cdev)
            bufs = [torch.empty_like(mine) for _ in range(mesh.world)]
            dist.all_gather(bufs, mine, group=mesh.group)
            g[k] = torch.cat(bufs).view(t.dtype).to(mesh.device)
        out.append(g)
    return out


def _model_slices(w_placed, m: int, mesh) -> list:
    """The ``m`` slices of ``w_placed`` (a 1-D leaf under ``P("model")``)
    in model order: the owned ones as they are held, the others (a
    process that owns fewer than ``m`` model coordinates, as each one of
    a world of ``mesh.size`` does) all-gathered over ``mesh.group``."""
    k = w_placed.shape[0] // m
    held = {s.placement[0][0] // k: s.data
            for s in w_placed.addressable_shards}
    if len(held) == m:
        return [held[j] for j in range(m)]
    import torch.distributed as dist
    from dmlc_tpu_torch.parallel.sharded import collective_device
    cdev = collective_device(mesh)
    # one row a model coordinate, its last column 1 where this rank
    # holds that slice
    buf = torch.zeros(m, k + 1, dtype=w_placed.dtype, device=cdev)
    for j, t in held.items():
        buf[j, :k] = t.detach().to(cdev)
        buf[j, k] = 1
    bufs = [torch.empty_like(buf) for _ in range(mesh.world)]
    dist.all_gather(bufs, buf, group=mesh.group)
    out = dict(held)
    for b in bufs:
        for j in range(m):
            if j not in out and bool(b[j, k] == 1):
                out[j] = b[j, :k].to(w_placed.device, copy=True)
    assert len(out) == m, \
        f"the gang holds {sorted(out)} of w's {m} model slices"
    return [out[j] for j in range(m)]


def model_axis_phase(path: str, n_parts: int, device, group=None,
                     its=None) -> float:
    """The dry run's 2-D (data x model) phase over the corpus at
    ``path``: the weight vector held as M = 2 slices over the model axis
    of a ``(n_parts // 2, 2)`` mesh (a PlacedTensor under
    ``NamedSharding(mesh2, P("model"))``; slices this process does not
    own are gathered over ``group``), concatenated before K1; K2's
    gradient splits back to the slices. Loss and gradients must match
    the unsharded computation on this process's batch. Returns the
    loss; the iterator it opens is appended to ``its`` to be closed."""
    from dmlc_tpu_torch.parallel.placement import NamedSharding, P, device_put
    from dmlc_tpu_torch.parallel.sharded import Mesh, ShardedRowBlockIter
    m = 2
    mesh2 = Mesh((n_parts // 2, m), ("data", "model"), group=group,
                 device=device)
    it2 = ShardedRowBlockIter(path, mesh2, format="libsvm",
                              row_bucket=ROW_BUCKET, nnz_bucket=NNZ_BUCKET)
    if its is not None:
        its.append(it2)
    b2 = next(iter(it2))
    w0 = torch.from_numpy(np.random.RandomState(11).randn(
        NUM_FEATURES).astype(np.float32)).to(device)
    w_placed = device_put(w0, NamedSharding(mesh2, P("model")), name="w")
    slices = [s.requires_grad_(True)
              for s in _model_slices(w_placed, m, mesh2)]
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
    return float(l_tp.detach())


def dryrun_multichip(n_parts: int, device=None, group=None
                     ) -> Dict[str, Any]:
    """The data-parallel dry run over a mesh of ``n_parts`` parts on
    ``device`` (``cuda`` by default: this process's card), all-reducing
    over ``group`` when one is given. At a world of W > 1 every rank of
    ``group`` calls it with the same ``n_parts``; each holds its
    ``n_parts / W`` parts, checks its own ``w`` and ``b`` against the
    golden over the gathered global batches, and the ranks' final ``w``
    and ``b`` must be bitwise equal. Raises AssertionError on any failed
    check; returns the final parameters and the figures it printed."""
    from dmlc_tpu_torch.models import SparseLinearModel
    from dmlc_tpu_torch.parallel.device_iter import resolve_device
    from dmlc_tpu_torch.parallel.sharded import Mesh, ShardedRowBlockIter
    device = resolve_device(device)
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

        # steady-epoch replay through the SAME iterator: in one process
        # epoch 2 re-parses and tees ("auto" streams epoch 1) and epoch 3
        # serves the retained rounds from memory; at a world > 1 "auto"
        # caches epoch 1, so epochs 2 and 3 are both served from memory
        # (replay_epochs 2). Either way epoch 3 comes from memory, its
        # batches identical to epoch 1
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

        # parity: replay the SAME global batches (every rank's parts,
        # gathered) through one flat golden step on this rank's device.
        # Any wrong all-reduce or mis-assigned part gives an O(1)
        # parameter error; bitwise equality is reported besides (the
        # sums may run in other orders)
        global_batches = _global_batches(batches, mesh)
        gparams = {"w": torch.zeros(NUM_FEATURES, device=device,
                                    requires_grad=True),
                   "b": torch.zeros((), device=device, requires_grad=True)}
        for _ in range(5):
            for batch in global_batches:
                _golden_step(gparams, batch)
        # one more step on EACH side, so the comparison also covers a
        # fresh gradient at the converged point
        _golden_step(gparams, global_batches[0])
        step(batches[0])
        w_mesh, w_gold = model.w.detach(), gparams["w"].detach()
        torch.testing.assert_close(w_mesh, w_gold, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(model.b.detach(), gparams["b"].detach(),
                                   rtol=RTOL, atol=ATOL)
        dm, dg = _digest(w_mesh), _digest(w_gold)
        if mesh.world > 1:
            # the all-reduced gradient is the same bits on every rank,
            # and so is every update: the ranks' w must be too
            ranks = _all_same(dm + _digest(model.b.detach()), mesh)
            assert len(set(ranks)) == 1, (
                f"rank {mesh.rank}: the ranks' final w and b differ "
                f"({[r.hex()[:12] for r in ranks]})")

        tp_note = ""
        if n_parts >= 4 and n_parts % 2 == 0:
            l_tp = model_axis_phase(path, n_parts, device, group, its)
            tp_note = (f"; model-axis phase OK (2-D {n_parts // 2}x2 "
                       f"data*model mesh, w held as 2 slices, loss+grad "
                       f"parity {l_tp:.4f})")
        _say(f"dryrun_multichip({n_parts}): loss {l0:.4f} -> {l5:.4f} "
             f"OK ({len(batches)} global batches through the "
             f"file→mesh stack); steady replay OK ({it.replay_epochs} "
             f"epoch(s) served from retained rounds, batches identical); "
             f"1-device parity {'BITWISE' if dm == dg else 'allclose'} "
             f"(mesh={dm} golden={dg}){tp_note}; world={mesh.world} "
             f"rank={mesh.rank} on {device}")
        return {"w": w_mesh.cpu().numpy(),
                "b": float(model.b.detach()), "loss0": l0, "loss5": l5,
                "batches": len(batches), "replay_epochs": it.replay_epochs,
                "world": mesh.world, "rank": mesh.rank}
    finally:
        for i in its:
            i.close()
        os.unlink(path)


def _worker(args) -> None:
    """One rank of the gang ``main`` launched: ``entry()`` on its device,
    then the dry run over the group."""
    import torch.distributed as dist
    from dmlc_tpu_torch.parallel.device_iter import resolve_device
    from dmlc_tpu_torch.parallel.launch import finalize, init_from_env
    rank, world = init_from_env(device=args.device if args.device == "cpu"
                                else None)
    device = resolve_device(args.device)  # the rank's card, once set
    fn, fargs = entry(device)
    _say(f"entry() compile+run: {float(fn(*fargs))}")
    out = dryrun_multichip(args.parts, device=device, group=dist.group.WORLD)
    if args.out:
        np.save(os.path.join(args.out, f"w-{rank}-of-{world}.npy"),
                out["w"])
    finalize()


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m dmlc_tpu_torch.graft [--device cpu] [--cards N]
    [--parts P]``, the twin of ``python __graft_entry__.py``.

    - ``--device cpu`` (one rank): ``entry()`` once, then
      ``dryrun_multichip(P)`` on a mesh of P = 8 parts in this process,
      as the reference's self-test runs on its 8 CPU devices.
    - On the card, ``--cards 1`` (the default on a host of one card):
      the same in a world-1 NCCL group.
    - ``--cards N >= 2`` (the default on a host of N cards): N ranks
      through ``launch_local``, one card each; each runs ``entry()`` on
      its card and ``dryrun_multichip(P, group=WORLD)``, P = 2N parts by
      default (the model-axis phase runs at P >= 4). With ``--device
      cpu`` the N ranks form a gloo group on the host.

    A host with fewer cards than N raises ``NotEnoughCardsError`` before
    any rank starts. Returns 0, or 1 when a rank of the gang failed."""
    from dmlc_tpu_torch.parallel.launch import (
        NotEnoughCardsError, find_free_port, launch_local, worker_envs,
    )
    from dmlc_tpu_torch.utils.logging import DMLCError
    ap = argparse.ArgumentParser(
        prog="python -m dmlc_tpu_torch.graft",
        description="entry() and the data-parallel dry run "
                    "(twin of python __graft_entry__.py)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default: NCCL, a card a rank) or cpu "
                         "(gloo)")
    ap.add_argument("--cards", type=int, default=None,
                    help="ranks of the gang, one card each (default: "
                         "every card of the host; 1 with --device cpu)")
    ap.add_argument("--parts", type=int, default=None,
                    help="mesh parts (default: 8 for one rank, 2 a rank "
                         "otherwise)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    cards = args.cards
    if cards is None:
        cards = max(1, torch.cuda.device_count()) if on_card else 1
    if args.parts is None:
        args.parts = 8 if cards == 1 else 2 * cards
    if args.worker:
        _worker(args)
        return 0
    if on_card and torch.cuda.device_count() < cards:
        raise NotEnoughCardsError(
            f"the dry run on the card runs {cards} NCCL rank(s), one "
            f"CUDA card each; this host has {torch.cuda.device_count()} "
            "(pass --device cpu for the host)")
    if cards == 1 and not on_card:
        fn, fargs = entry("cpu")
        print("entry() compile+run:", float(fn(*fargs)), flush=True)
        dryrun_multichip(args.parts, device="cpu")
        return 0
    # the ranks' NCCL bootstrap over loopback: every rank is on this host
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if cards == 1:
        os.environ.update(worker_envs(f"127.0.0.1:{find_free_port()}", 1, 0))
        _worker(args)
        return 0
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {"PYTHONPATH": os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])}
    cmd = [sys.executable, "-m", "dmlc_tpu_torch.graft", "--worker",
           "--device", args.device, "--cards", str(cards),
           "--parts", str(args.parts)]
    if args.out:
        cmd += ["--out", args.out]
    try:
        launch_local(cards, cmd, env=env, timeout=600)
    except DMLCError as e:
        print(f"dry run gang failed: {e}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
