"""Device ops over CSR batches: the CUDA kernels and their plain versions.

Counterpart of ``dmlc_tpu/ops/csr.py``, where XLA compiled these from
jnp. Here each device computation is a CUDA kernel written by hand
(``csrc/csr_spmv.cu``, ``csrc/csr_ops.cu``) with a plain PyTorch version
of the same function beside it:

- K1 ``csr_spmv``:    y[i] = Σ_{offset[i] ≤ k < offset[i+1]} value[k]·w[index[k]]
- K2 ``csr_spmv_t``:  grad_w[index[k]] += value[k]·g[row(k)], over one CSR
  block or over the L parts of a stacked one (``[L, ...]`` columns) into
  one grad_w
- K3 ``sdot_rows``:   y[n] = Σ_k w[index[n,k]]·value[n,k] over padded ELL rows
- K4 ``csr_to_dense``: dense[row(k), index[k]] += value[k], a zeroed
  ``[rows, cols]`` float32 matrix (duplicate columns of a row add up)

A wrapper runs the plain version only when its tensors lie on the CPU;
for CUDA tensors it launches the kernel or raises. K1 has two routes on
the card, which :func:`csr_spmv_route` picks from the batch's nonzeros a
row: "half" (16 lanes a row) and "warp" (32). K2 has two, which
:func:`csr_spmv_t_route` picks from the model's width, the batch's
nonzeros of all its parts and the card: "global" (K1's lanes a row, one
atomic into grad_w per nonzero) and "private" (each block sums into its
own copy of grad_w in shared memory, then adds it into grad_w). K4 has
two, which :func:`csr_to_dense_route` picks from the matrix's width and
the card: "tile" (a block builds
K4_TILE_ROWS rows of the matrix in shared memory and writes them once)
and "global" (one atomic into a zeroed matrix per nonzero). Each wrapper
counts its kernel launches in ``.launches``. ``csr_to_padded_rows`` is the
host-side (numpy) CSR → ELL conversion that feeds K3.

Index semantics follow the reference (``ops/index.py``: low 32 bits,
signed, negative counted from the end): an invalid index gives its row
NaN in K1 and K3 (``jnp.take`` fills NaN) and is dropped by K2 and K4.
Nonzeros past ``offset[-1]`` (the padded tail) belong to no row. The
index keeps its layout dtype (u32/u64, or int32 from
``csr_to_padded_rows``; torch cannot index with unsigned types, so the
plain versions widen it to int64 and the kernels read it as it is).
Offsets stay int64 on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dmlc_tpu_torch.ops.index import wrap_index
from dmlc_tpu_torch.ops.kernels import (
    INDEX_BYTES, count, launch, max_shared_bytes,
)
from dmlc_tpu_torch.utils.logging import check

__all__ = ["csr_row_ids", "segment_spmv", "spmv", "parts_spmv", "csr_spmv",
           "csr_spmv_t",
           "csr_spmv_plain", "csr_spmv_t_plain", "csr_spmv_route",
           "csr_spmv_t_route",
           "sdot_rows",
           "sdot_rows_plain", "csr_to_dense", "csr_to_dense_plain",
           "csr_to_dense_route", "csr_to_padded_rows", "sharded_spmv",
           "segment_sum"]

def csr_row_ids(offset: torch.Tensor, nnz: int) -> torch.Tensor:
    """Row id of every nonzero: row_ids[k] = i s.t. offset[i] <= k < offset[i+1].

    Padded tail entries (k >= offset[-1]) map to row n (one past the last)
    so that segment sums can drop them.
    """
    k = torch.arange(nnz, dtype=offset.dtype, device=offset.device)
    return torch.searchsorted(offset, k, right=True) - 1


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: Optional[int] = None) -> torch.Tensor:
    """out[s] = Σ data[k] over the k whose ``segment_ids[k] == s``, with
    ``jax.ops.segment_sum``'s semantics: ``num_segments`` rows out (the
    largest id + 1 when None), ids outside ``[0, num_segments)`` dropped,
    an empty segment 0. ``segment_ids`` is 1-D, one id a row of
    ``data``. A plain tensor function (the reference's public segment
    sum), not a kernel: nothing on the kernel path calls it."""
    ids = segment_ids.to(device=data.device, dtype=torch.int64)
    check(ids.dim() == 1 and data.dim() >= 1
          and ids.numel() == data.shape[0],
          f"segment_sum: segment_ids {tuple(segment_ids.shape)} needs one "
          f"id a row of data {tuple(data.shape)}")
    if num_segments is None:
        num_segments = int(ids.max()) + 1 if ids.numel() else 0
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids[keep], data[keep])


def _check_index_value(index, value, dims):
    check(index.dtype in INDEX_BYTES,
          f"index dtype must be uint32/uint64/int32, got {index.dtype}")
    check(index.dim() == dims and index.shape == value.shape,
          f"index and value must be {dims}-D of one shape, got "
          f"{tuple(index.shape)} and {tuple(value.shape)}")
    check(value.dtype == torch.float32,
          f"value must be float32, got {value.dtype}")


def _check_device(tensors, what):
    devices = {t.device for t in tensors}
    check(len(devices) == 1, f"{what} must share one device, got "
          f"{sorted(str(d) for d in devices)}")


def _check_csr(offset, index, value, dense=None, dense_name="",
               dense_dim=1):
    check(offset.dim() == 1 and offset.numel() >= 1
          and offset.dtype == torch.int64,
          f"offset must be 1-D int64 with >= 1 entry, got "
          f"{tuple(offset.shape)} {offset.dtype}")
    _check_index_value(index, value, 1)
    if dense is None:
        _check_device((offset, index, value), "CSR tensors")
        return
    check(dense.dtype == torch.float32,
          f"{dense_name} must be float32, got {dense.dtype}")
    check(dense.dim() == dense_dim, f"{dense_name} must be {dense_dim}-D")
    _check_device((offset, index, value, dense),
                  f"CSR tensors and {dense_name}")


def _launch(name, offset, index, value, dense, num_rows, num_features, out,
            *extra):
    for t in (offset, index, value, dense, out):
        check(t.is_contiguous(), "the CSR kernels need contiguous tensors")
    launch(name, dense.device, offset.data_ptr(), index.data_ptr(),
           INDEX_BYTES[index.dtype], value.data_ptr(), dense.data_ptr(),
           num_rows, index.numel(), num_features, out.data_ptr(), *extra)


def _segment_ids(offset: torch.Tensor, nnz: int) -> torch.Tensor:
    """csr_row_ids with every nonzero outside the rows (the padded tail,
    and any before offset[0]) sent to row n, which the sums drop."""
    n = offset.numel() - 1
    rows = csr_row_ids(offset, nnz)
    return torch.where(rows < 0, n, rows)


def csr_spmv_plain(offset: torch.Tensor, index: torch.Tensor,
                   value: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: gather, then index_add_ over the row ids."""
    n = offset.numel() - 1
    idx, inside = wrap_index(index, w.numel())
    gathered = torch.where(inside, w[idx], float("nan"))
    y = torch.zeros(n + 1, dtype=w.dtype, device=w.device)
    y.index_add_(0, _segment_ids(offset, index.numel()), value * gathered)
    return y[:n]


def csr_spmv_t_plain(offset: torch.Tensor, index: torch.Tensor,
                     value: torch.Tensor, g: torch.Tensor,
                     num_features: int) -> torch.Tensor:
    """Plain version of K2, flat (offset ``[R+1]``, index and value
    ``[nnz]``, g ``[R]``) or stacked (``[L, R+1]``, ``[L, nnz]``, ``[L,
    R]``): one index_add_ of value·g[row] over every part's nonzeros below
    that part's offset[-1] into one grad_w."""
    if offset.dim() == 1:
        offset, index, value, g = (t[None] for t in (offset, index, value, g))
    n = offset.shape[1] - 1
    k = torch.arange(index.shape[1], dtype=offset.dtype,
                     device=offset.device).expand(index.shape).contiguous()
    rows = torch.searchsorted(offset.contiguous(), k, right=True) - 1
    rows = torch.where((rows < 0) | (rows >= n), n, rows)  # n: no row
    idx, keep = wrap_index(index, num_features)
    g_ext = torch.cat([g, g.new_zeros(g.shape[0], 1)], dim=1)
    contrib = torch.where(keep & (rows < n), value * g_ext.gather(1, rows),
                          0.0)
    grad = torch.zeros(num_features, dtype=g.dtype, device=g.device)
    grad.index_add_(0, idx.flatten(), contrib.flatten())
    return grad


# K1's half route (16 lanes a row, 4 nonzeros a lane at once) takes rows
# of up to this many nonzeros in one pass; the bucket's rows beyond it take
# the warp route (32 lanes, 5 at once).
K1_HALF_MAX_PER_ROW = 64
K1_LANES = {"half": 16, "warp": 32}
_INT32_MAX = 2**31 - 1


def csr_spmv_route(nnz: int, rows: int) -> str:
    """K1's route for a batch of ``rows`` rows and ``nnz`` nonzeros (its
    bucket, padded tail included): ``"half"`` where the bucket holds at
    most K1_HALF_MAX_PER_ROW nonzeros a row, else ``"warp"``. On an H100
    the half route took 3.84–3.99 µs at the linear batch (45 a row) and
    4.08 at the FM batch (40), against 4.39 and 4.52–4.77 for the warp a
    row that K1 had before; at the ranking batch (136 a row) it took 2.81
    against 2.66, and the warp route 2.33 (PERF.md §6)."""
    return "half" if nnz <= K1_HALF_MAX_PER_ROW * rows else "warp"


def csr_spmv(offset: torch.Tensor, index: torch.Tensor, value: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """K1: y[offset.numel()-1] = CSR · w (see module docstring)."""
    _check_csr(offset, index, value, w, "w")
    n = offset.numel() - 1
    if w.device.type == "cpu":
        return csr_spmv_plain(offset, index, value, w)
    check(w.is_cuda, f"csr_spmv runs on cuda or cpu, got {w.device}")
    check(index.numel() <= _INT32_MAX and n < _INT32_MAX,
          f"csr_spmv takes fewer than 2^31 nonzeros and rows, got "
          f"{index.numel()} and {n}")
    y = torch.empty(n, dtype=torch.float32, device=w.device)
    _launch("dmlc_csr_spmv", offset, index, value, w, n,
            w.numel(), y, K1_LANES[csr_spmv_route(index.numel(), n)])
    count(csr_spmv)
    return y


# K2's private route: blocks an SM at most (each of 32 warps, one row at a
# time), and the most global atomics its flush (one a weight a block) may
# take per nonzero of the batch.
K2_BLOCKS_PER_SM = 2
K2_FLUSH_PER_NNZ = 8


def csr_spmv_t_route(num_features: int, nnz: int, sms: int,
                     max_shared: int) -> str:
    """K2's route on a card of ``sms`` SMs whose blocks may opt in to
    ``max_shared`` bytes of shared memory (the private kernel has no
    static shared memory), for a model of ``num_features`` weights and a
    call of ``nnz`` nonzeros (the buckets of all its parts, padded tails
    included): ``"private"`` where the F floats of grad_w fit a block's
    shared memory and the flush, K2_BLOCKS_PER_SM · sms · F global
    atomics, is at most K2_FLUSH_PER_NNZ per nonzero; else
    ``"global"``. On an H100 (132 SMs), at 4096 rows of 136 nonzeros, the
    private route ran 7.3×, 9.3×, 2.0× and 1.24× faster than the global
    one at 137, 1,024, 8,192 and 16,384 weights, and 1.17× slower at
    32,768 (a sweep of both routes, PERF.md §6). The constant 8 puts
    the boundary between the last two: at that batch the rule's flush is
    7.8 atomics a nonzero at 16,384 weights and 15.5 at 32,768."""
    if not 0 < num_features * 4 <= max_shared:
        return "global"
    flush = K2_BLOCKS_PER_SM * sms * num_features
    return "private" if flush <= K2_FLUSH_PER_NNZ * nnz else "global"


# The most parts one K2 launch takes (its grid's second dimension).
K2_MAX_PARTS = 65535


def csr_spmv_t(offset: torch.Tensor, index: torch.Tensor, value: torch.Tensor,
               g: torch.Tensor, num_features: int) -> torch.Tensor:
    """K2: grad_w[num_features] = CSRᵀ · g of one CSR block (offset
    ``[R+1]``, index and value ``[nnz]``, g ``[R]``), or Σ_p CSR_pᵀ · g_p
    over the L parts of a stacked one (``[L, R+1]``, ``[L, nnz]``, ``[L,
    R]``; each part its own padded block): one zero fill and one launch
    either way (see module docstring)."""
    dims = offset.dim()
    check(dims in (1, 2) and offset.shape[-1] >= 1
          and offset.dtype == torch.int64,
          f"offset must be [R+1] or [L, R+1] int64 with >= 1 entry a part, "
          f"got {tuple(offset.shape)} {offset.dtype}")
    _check_index_value(index, value, dims)
    check(g.dtype == torch.float32, f"g must be float32, got {g.dtype}")
    _check_device((offset, index, value, g), "CSR tensors and g")
    check(dims == 1 or index.shape[0] == offset.shape[0],
          f"index and value must hold a row of nonzeros a part "
          f"({offset.shape[0]}), got {tuple(index.shape)}")
    n = offset.shape[-1] - 1
    rows_shape = tuple(offset.shape[:-1]) + (n,)
    check(tuple(g.shape) == rows_shape, f"g must have one entry per row "
          f"{rows_shape}, got {tuple(g.shape)}")
    if g.device.type == "cpu":
        return csr_spmv_t_plain(offset, index, value, g, num_features)
    check(g.is_cuda, f"csr_spmv_t runs on cuda or cpu, got {g.device}")
    parts, nnz = (1 if dims == 1 else offset.shape[0]), index.shape[-1]
    check(nnz <= _INT32_MAX and parts * n < _INT32_MAX
          and parts <= K2_MAX_PARTS,
          f"csr_spmv_t takes fewer than 2^31 nonzeros a part and rows in "
          f"all, and at most {K2_MAX_PARTS} parts, got {nnz}, {parts * n} "
          f"and {parts}")
    for t in (offset, index, value, g):
        check(t.is_contiguous(), "csr_spmv_t needs contiguous tensors")
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    private = csr_spmv_t_route(num_features, parts * nnz, sms,
                               max_shared_bytes(g.device)) == "private"
    grad = torch.zeros(num_features, dtype=torch.float32, device=g.device)
    launch("dmlc_csr_spmv_t", g.device, offset.data_ptr(), index.data_ptr(),
           INDEX_BYTES[index.dtype], value.data_ptr(), g.data_ptr(), parts,
           n, nnz, num_features, grad.data_ptr(),
           K1_LANES[csr_spmv_route(nnz, n)],
           K2_BLOCKS_PER_SM * sms if private else 0)
    count(csr_spmv_t)
    return grad


csr_spmv.launches = 0
csr_spmv_t.launches = 0


class _CSRSpMV(torch.autograd.Function):
    """y = CSR · w, flat or over the L parts of a stacked batch (y [L,
    R]), with K1 forward (a launch a part) and K2 backward (one launch for
    all the parts, so w's gradient is one zeroed vector with no sum over
    parts after it); the gradient is in w only: the CSR batch is data."""

    @staticmethod
    def forward(ctx, offset, index, value, w):
        ctx.save_for_backward(offset, index, value)
        ctx.num_features = w.numel()
        if offset.dim() == 1:
            return csr_spmv(offset, index, value, w)
        return torch.stack([csr_spmv(o, i, v, w)
                            for o, i, v in zip(offset, index, value)])

    @staticmethod
    def backward(ctx, g):
        offset, index, value = ctx.saved_tensors
        grad_w = None
        if ctx.needs_input_grad[3]:
            grad_w = csr_spmv_t(offset, index, value, g.contiguous(),
                                ctx.num_features)
        return None, None, None, grad_w


def segment_spmv(offset: torch.Tensor, index: torch.Tensor,
                 value: torch.Tensor, weights: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    """y[i] = Σ_{k in row i} value[k] * weights[index[k]] (CSR · dense),
    differentiable in ``weights``.

    Padded nonzeros must carry value 0 (the padding layer guarantees it).
    ``num_rows`` must equal ``offset.numel() - 1`` (the row bucket).
    """
    check(num_rows == offset.numel() - 1,
          f"num_rows {num_rows} != offset rows {offset.numel() - 1}")
    return _CSRSpMV.apply(offset, index, value, weights)


def spmv(offset, index, value, weights) -> torch.Tensor:
    """Convenience wrapper: num_rows from offset shape."""
    return segment_spmv(offset, index, value, weights,
                        num_rows=offset.numel() - 1)


def parts_spmv(offset: torch.Tensor, index: torch.Tensor,
               value: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """y ``[L, R]``: each part's CSR · ``weights`` over the L parts of a
    stacked batch (offset ``[L, R+1]``, index and value ``[L, nnz]``, each
    part its own padded block), differentiable in ``weights``: K1 a part,
    and in the backward one K2 launch for all L parts."""
    check(offset.dim() == 2 and index.dim() == 2
          and index.shape[0] == offset.shape[0],
          f"parts_spmv takes a stacked batch, offset [L, R+1] and index "
          f"[L, nnz], got {tuple(offset.shape)} and {tuple(index.shape)}")
    return _CSRSpMV.apply(offset, index, value, weights)


def sharded_spmv(batch, weights: torch.Tensor, mesh,
                 axis: str = "data") -> torch.Tensor:
    """SpMV over a sharded batch (``parallel.sharded`` layout): each
    column is ``[L, ...]``, this process's L parts along ``axis`` of
    ``mesh``, each part its own padded CSR block. Returns y ``[L,
    row_bucket]``, part p's rows in row p, differentiable in
    ``weights`` (counterpart of the reference's ``sharded_spmv``, K1
    under ``shard_map``), through :func:`parts_spmv`.

    Each part stays its own block, exactly the reference's: its offsets
    its own, its padded tail past its ``offset[-1]`` never visited, so no
    part's tail has to belong to a row. K1 launches once a part. The
    backward is one K2 launch that takes every part's block by its own
    offsets and adds them all into one zeroed gradient of ``weights``,
    as the reference's one ``jax.vjp`` over ``shard_map`` gives one."""
    num_parts = len(mesh.local_parts(axis))
    check(batch["offset"].shape[0] == num_parts,
          f"the batch holds {batch['offset'].shape[0]} parts, the mesh "
          f"gives this process {num_parts} along {axis!r}")
    return parts_spmv(batch["offset"], batch["index"], batch["value"],
                      weights)


# ------------------------------------------------------------ K3, K4

def csr_to_padded_rows(offset: np.ndarray, index: np.ndarray,
                       value: Optional[np.ndarray],
                       max_nnz_per_row: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side CSR → padded ELL (index[n,k] int32, value[n,k] float32,
    mask[n,k] bool), the input of K3.

    Pads index with 0 and value with 0.0. A row longer than ``k`` keeps
    its first ``k`` nonzeros; ``value=None`` means all ones. The index is
    stored as int32 as numpy casts it (a u32/u64 index keeps its low 32
    bits), byte for byte the reference's output.
    """
    offset = np.asarray(offset, np.int64)
    n = len(offset) - 1
    lens = np.diff(offset)
    k = int(max_nnz_per_row if max_nnz_per_row is not None
            else (lens.max() if n else 0))
    out_idx = np.zeros((n, k), np.int32)
    out_val = np.zeros((n, k), np.float32)
    mask = np.zeros((n, k), bool)
    vals = (np.asarray(value, np.float32) if value is not None
            else np.ones(len(index), np.float32))
    for i in range(n):
        m = min(int(lens[i]), k)
        lo = int(offset[i])
        out_idx[i, :m] = index[lo:lo + m]
        out_val[i, :m] = vals[lo:lo + m]
        mask[i, :m] = True
    return out_idx, out_val, mask


def sdot_rows_plain(padded_index: torch.Tensor, padded_value: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: gather (NaN for an invalid index), then sum
    each row."""
    idx, inside = wrap_index(padded_index, w.numel())
    gathered = torch.where(inside, w[idx], float("nan"))
    return (gathered * padded_value).sum(-1)


def sdot_rows(padded_index: torch.Tensor, padded_value: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """K3: y[n] = Σ_k w[index[n,k]]·value[n,k] over padded ELL rows (the
    reference's batched Row::SDot)."""
    _check_index_value(padded_index, padded_value, 2)
    check(w.dim() == 1 and w.dtype == torch.float32,
          f"w must be 1-D float32, got {tuple(w.shape)} {w.dtype}")
    _check_device((padded_index, padded_value, w), "ELL tensors and w")
    if w.device.type == "cpu":
        return sdot_rows_plain(padded_index, padded_value, w)
    check(w.is_cuda, f"sdot_rows runs on cuda or cpu, got {w.device}")
    for t in (padded_index, padded_value, w):
        check(t.is_contiguous(), "sdot_rows needs contiguous tensors")
    n, k = padded_index.shape
    y = torch.empty(n, dtype=torch.float32, device=w.device)
    launch("dmlc_sdot_rows", w.device, padded_index.data_ptr(),
           INDEX_BYTES[padded_index.dtype], padded_value.data_ptr(),
           w.data_ptr(), n, k, w.numel(), y.data_ptr())
    count(sdot_rows)
    return y


def csr_to_dense_plain(offset: torch.Tensor, index: torch.Tensor,
                       value: torch.Tensor, num_cols: int) -> torch.Tensor:
    """Plain version of K4: index_put_ with accumulation into zeros; the
    padded tail and invalid columns are dropped."""
    n = offset.numel() - 1
    rows = _segment_ids(offset, index.numel())
    cols, keep = wrap_index(index, num_cols)
    keep = keep & (rows < n)
    dense = torch.zeros(n, num_cols, dtype=torch.float32,
                        device=value.device)
    dense.index_put_((rows[keep], cols[keep]), value[keep], accumulate=True)
    return dense


# K4's tile route: the rows a block builds in shared memory, one a warp (a
# multiple of 4, so that each block's run of the matrix starts on 16
# bytes). On an H100 at the ranking batch (4096 rows x 137 columns) 8 rows
# a block took 3.13 µs, 4 took 4.19, 16 3.78 and 32 5.11 (PERF.md §6).
K4_TILE_ROWS = 8


def csr_to_dense_route(num_cols: int, max_shared: int) -> str:
    """K4's route for a matrix of ``num_cols`` columns on a card whose
    blocks may opt in to ``max_shared`` bytes of shared memory (the tile
    kernel has no static shared memory): ``"tile"`` where K4_TILE_ROWS
    rows of the matrix fit a block's shared memory, else ``"global"``."""
    return ("tile" if 0 < K4_TILE_ROWS * num_cols * 4 <= max_shared
            else "global")


def csr_to_dense(offset: torch.Tensor, index: torch.Tensor,
                 value: torch.Tensor, num_rows: int,
                 num_cols: int) -> torch.Tensor:
    """K4: the CSR batch scattered into a dense [num_rows, num_cols]
    float32 matrix; ``num_rows`` must equal ``offset.numel() - 1``."""
    _check_csr(offset, index, value)
    check(num_rows == offset.numel() - 1,
          f"num_rows {num_rows} != offset rows {offset.numel() - 1}")
    check(num_cols >= 0, f"num_cols must be >= 0, got {num_cols}")
    if value.device.type == "cpu":
        return csr_to_dense_plain(offset, index, value, num_cols)
    check(value.is_cuda,
          f"csr_to_dense runs on cuda or cpu, got {value.device}")
    for t in (offset, index, value):
        check(t.is_contiguous(), "csr_to_dense needs contiguous tensors")
    tile = csr_to_dense_route(num_cols,
                              max_shared_bytes(value.device)) == "tile"
    # the tile route writes every entry; the global route adds into zeros
    dense = (torch.empty if tile else torch.zeros)(
        num_rows, num_cols, dtype=torch.float32, device=value.device)
    launch("dmlc_csr_to_dense", value.device, offset.data_ptr(),
           index.data_ptr(), INDEX_BYTES[index.dtype], value.data_ptr(),
           num_rows, index.numel(), num_cols, dense.data_ptr(),
           K4_TILE_ROWS if tile else 0)
    count(csr_to_dense)
    return dense


sdot_rows.launches = 0
csr_to_dense.launches = 0
