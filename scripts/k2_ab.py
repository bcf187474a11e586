#!/usr/bin/env python3
"""K2 (``csr_spmv_t``) and the sharded step of this tree against a parent
tree's, in turns on one CUDA card.

Usage, from the root of a checkout on a machine with a CUDA card:
``python3 scripts/k2_ab.py --parent DIR [--order ABBA] [--out DIR]``.
DIR holds the parent commit's ``dmlc_tpu_torch/`` (for example ``git
archive <commit> dmlc_tpu_torch | tar -x -C DIR``). The script builds
this tree's kernels and engine, writes a CORPUS_MB cut of chip_smoke's
Criteo-shaped corpus (its first 8192 rows are those of chip_smoke's),
and keeps the main path's first batch and the first sharded batch of 4
parts (``ShardedRowBlockIter``, 8192 rows, ``nnz_bucket`` 368640). Then
one child process a turn, on tree A (the parent) or B (this tree), each
with that tree's package and kernels built from its sources:

- K2 at the linear batch: device µs of its kernel and of its zero fill
  (torch.profiler over 50 calls), host µs a call;
- K2 over the 4 parts: the way of tree A's sharded step, a call a part
  and 3 adds, and on B the one launch over all parts;
- one ``SparseLinearModel(10^6)`` sharded step over a world-1 NCCL group
  (chip_smoke's ``init_nccl``): its launches and device µs, by kind;
- the SM clock after each trace, and each tree's SASS of its K2 kernels
  (``cuobjdump -sass``: its atomic instructions, by kind).

Each call is held to its plain version before it is timed. Then the
library call, Σ_p A_pᵀ g_p as one ``torch.sparse`` product, and the
bounds. It prints every turn's numbers, a JSON summary (also written to
``DIR/k2_ab.json``) and the card's name and power limit.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_MB = 64
ITERS = 50
OPS = ("REDG", "RED", "ATOMG", "ATOMS", "ATOM")
STEP_TRACES = 3


def _sass_atomics(lib):
    """{kernel: {op: [count, first instruction]}} of each csr_spmv_t
    kernel in the library ``lib``, from ``cuobjdump -sass``, for each op of
    OPS: REDG and RED an atomic whose result is unused, ATOMG and ATOM one
    whose result comes back, ATOMS one on shared memory."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        return {"error": out.stderr.strip()[-300:]}
    found, name = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "csr_spmv_t" in m.group(1) else None
            if name:
                found[name] = {}
        elif name:
            for op in OPS:
                m = re.search(rf"\b{op}\.[\w.]*", line)
                if m:
                    seen = found[name].setdefault(op, [0, m.group(0)])
                    seen[0] += 1
                    break
    return found


def child(tree, inputs, out_path):
    """One turn: tree's package on the card, the measurements above."""
    sys.path[:0] = [tree, REPO]
    import numpy as np
    import torch
    import chip_smoke as cs
    from dmlc_tpu_torch.models.linear import SparseLinearModel
    from dmlc_tpu_torch.native.build import build_kernels
    from dmlc_tpu_torch.ops import csr
    from dmlc_tpu_torch.utils.logging import DMLCError
    import dmlc_tpu_torch
    assert os.path.dirname(dmlc_tpu_torch.__file__).startswith(tree), (
        dmlc_tpu_torch.__file__, tree)
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    cuda = torch.device("cuda")
    lib = build_kernels()
    data = np.load(inputs)
    F = cs.NUM_FEATURES
    rng = np.random.RandomState(cs.SEED + 1)
    flat = [torch.from_numpy(data[f"flat_{k}"]).to(cuda)
            for k in ("offset", "index", "value")]
    n = flat[0].numel() - 1
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
    sh = {k[3:]: torch.from_numpy(data[k]).to(cuda)
          for k in data.files if k.startswith("sh_")}
    parts = sh["offset"].shape[0]
    gp = torch.from_numpy(rng.randn(parts, n).astype(np.float32)).to(cuda)
    res = {"tree": tree, "sass": _sass_atomics(lib)}

    def close(got, want, what):
        torch.cuda.synchronize()
        err = (got - want).abs()
        assert bool((err <= cs.K2_ATOL + cs.K2_RTOL * want.abs()).all()), (
            what, err.max().item())
        return err.max().item()

    def k2():
        return csr.csr_spmv_t(*flat, g, F)

    res["flat_err"] = close(k2(), csr.csr_spmv_t_plain(*flat, g, F), "flat")
    fill, kernel = cs._fill_and_kernel(k2, "csr_spmv_t", "global", ITERS)
    res["flat"] = {"kernel_us": kernel * 1e3, "fill_us": fill * 1e3,
                   "sm_clock": cs.sm_clock(),
                   "call_us": cs.call_ms(k2) * 1e3}

    cols = [sh[k] for k in ("offset", "index", "value")]

    def per_part():
        acc = csr.csr_spmv_t(*(c[0] for c in cols), gp[0], F)
        for p in range(1, parts):
            acc += csr.csr_spmv_t(*(c[p] for c in cols), gp[p], F)
        return acc

    want = torch.stack([csr.csr_spmv_t_plain(*(c[p] for c in cols), gp[p],
                                             F) for p in range(parts)]).sum(0)
    res["per_part_err"] = close(per_part(), want, "per part")
    by = cs._device_us_by_kernel(lambda: [per_part() for _ in range(ITERS)],
                                 ITERS)
    res["per_part"] = {"device_us": sum(t for t, _ in by.values()),
                       "launches": sum(c for _, c in by.values()),
                       "sm_clock": cs.sm_clock()}

    def one_call():
        return csr.csr_spmv_t(*cols, gp, F)

    try:
        got = one_call()
    except DMLCError as e:  # a wrapper of one part only
        res["parts"] = f"no call over the parts in this tree: {e}"[:200]
    else:
        res["parts_err"] = close(got, want, "one launch")
        fill, kernel = cs._fill_and_kernel(one_call, "csr_spmv_t", "global",
                                           ITERS)
        res["parts"] = {"kernel_us": kernel * 1e3, "fill_us": fill * 1e3,
                        "sm_clock": cs.sm_clock(),
                        "call_us": cs.call_ms(one_call) * 1e3}

    mesh = cs.init_nccl()
    model = SparseLinearModel(F, learning_rate=cs.LEARNING_RATE,
                              device=cuda)
    step = model.make_sharded_train_step(mesh)
    for _ in range(3):
        step(sh)
    torch.cuda.synchronize()
    res["step"] = [cs.step_trace("sharded", lambda: step(sh))
                   for _ in range(STEP_TRACES)]
    import torch.distributed as dist
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(res, f)


def prepare(work):
    """The inputs every turn reads: the main path's first batch and the
    first sharded batch of 4 parts, as numpy, in ``work``/inputs.npz;
    with the library time and the bounds of the K2 calls on them."""
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import chip_smoke as cs
    from dmlc_tpu_torch.parallel.sharded import Mesh
    cs.FILE_MB = CORPUS_MB
    path = os.path.join(work, "criteo_shaped.libsvm")
    cs.write_corpus(path)
    first = cs.first_batch(path)
    mesh = Mesh((cs.SHARD_PARTS,), ("data",), device=torch.device("cuda"))
    batch = cs.first_sharded_batches(path, mesh, "libsvm", count=1)[0]
    host = {k: v.cpu().numpy() for k, v in batch.items()}
    arrays = {f"flat_{k}": first[k] for k in ("offset", "index", "value")}
    arrays.update({f"sh_{k}": v for k, v in host.items()})
    inputs = os.path.join(work, "inputs.npz")
    np.savez(inputs, **arrays)

    F, n = cs.NUM_FEATURES, cs.ROW_BUCKET
    nnz = int(first["num_nnz"])
    nnzs = [int(x) for x in host["num_nnz"]]
    parts = len(nnzs)
    out = {"flat_nnz": nnz, "parts_nnz": nnzs}
    out["flat_bound_us"] = cs.bound_ms(
        (n + 1) * 8 + nnz * 8 + n * 4 + F * 4, 2 * nnz)[0] * 1e3
    nbytes = parts * ((n + 1) * 8 + n * 4) + sum(nnzs) * 8 + F * 4
    out["parts_bytes"] = nbytes
    out["parts_bound_us"] = cs.bound_ms(nbytes, 2 * sum(nnzs))[0] * 1e3
    cuda = torch.device("cuda")
    rng = np.random.RandomState(cs.SEED + 1)
    rng.randn(n)
    gp = torch.from_numpy(rng.randn(parts, n).astype(np.float32)).to(cuda)
    crow = np.concatenate([[0]] + [host["offset"][p, 1:] + sum(nnzs[:p])
                                   for p in range(parts)])
    col = np.concatenate([host["index"][p, :nnzs[p]]
                          for p in range(parts)]).astype(np.int64)
    val = np.concatenate([host["value"][p, :nnzs[p]] for p in range(parts)])
    a = torch.sparse_csr_tensor(*(torch.from_numpy(x).to(cuda)
                                  for x in (crow, col, val)),
                                size=(parts * n, F))
    at, g_flat = a.t(), gp.flatten()
    try:
        at @ g_flat
        out["parts_library_us"] = cs.device_ms(lambda: at @ g_flat) * 1e3
    except RuntimeError as e:
        out["parts_library_us"] = f"not timed: {e}"[:200]
    return inputs, out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a directory holding the parent "
                    "tree's dmlc_tpu_torch/")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", default=None, help="directory for k2_ab.json")
    ap.add_argument("--child", nargs=3, metavar=("TREE", "INPUTS", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(*args.child)
        return
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    card = cs.environment()
    cs.build_all()
    trees = {"A": os.path.abspath(args.parent), "B": REPO}
    cs.require(os.path.isdir(os.path.join(trees["A"], "dmlc_tpu_torch")),
               f"no dmlc_tpu_torch/ under {trees['A']}")
    work = tempfile.mkdtemp(prefix="dmlc_k2_ab_")
    try:
        inputs, summary = prepare(work)
        summary["turns"] = []
        for i, side in enumerate(args.order):
            out = os.path.join(work, f"turn{i}.json")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 trees[side], inputs, out], timeout=900)
            cs.require(proc.returncode == 0,
                       f"turn {i} ({side}) exited {proc.returncode}")
            with open(out) as f:
                turn = json.load(f)
            turn["side"] = side
            summary["turns"].append(turn)
            steps = turn["step"]
            cs.log(f"turn {i} {side}: K2 at the linear batch kernel "
                   f"{turn['flat']['kernel_us']:.2f} + fill "
                   f"{turn['flat']['fill_us']:.2f} us (SM "
                   f"{turn['flat']['sm_clock']}); a call a part and 3 adds "
                   f"{turn['per_part']['device_us']:.2f} us in "
                   f"{turn['per_part']['launches']} launches; one launch "
                   f"over the parts {turn['parts']}; sharded step "
                   + ", ".join(f"{s['launches']} launches {s['device_us']:.2f}"
                               f" us (SM {s['sm_clock']})" for s in steps)
                   + f"; SASS {turn['sass']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    text = json.dumps(summary)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "k2_ab.json"), "w") as f:
            f.write(text)
    cs.log(text)
    cs.log(card)


if __name__ == "__main__":
    main()
