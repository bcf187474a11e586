"""Device ops over CSR batches: the CSR SpMV kernels and their plain versions.

Counterpart of ``dmlc_tpu/ops/csr.py``, where XLA compiled these from
jnp. Here each device computation is a CUDA kernel written by hand
(``csrc/csr_spmv.cu``) with a plain PyTorch version of the same function
beside it:

- K1 ``csr_spmv``:   y[i] = Σ_{offset[i] ≤ k < offset[i+1]} value[k]·w[index[k]]
- K2 ``csr_spmv_t``: grad_w[index[k]] += value[k]·g[row(k)]

A wrapper runs the plain version only when its tensors lie on the CPU;
for CUDA tensors it launches the kernel or raises. Each wrapper counts
its kernel launches in ``.launches``.

Out-of-range semantics follow the reference: an index at or past
``len(w)`` gives its row NaN in K1 (``jnp.take`` fills NaN) and is
dropped by K2. Nonzeros past ``offset[-1]`` (the padded tail) belong to
no row. The index keeps its layout dtype (u32/u64; torch cannot index
with unsigned types, so the plain versions widen it to int64 and the
kernels read it as it is). Offsets stay int64 on the device.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["csr_row_ids", "segment_spmv", "spmv", "csr_spmv", "csr_spmv_t",
           "csr_spmv_plain", "csr_spmv_t_plain"]

_INDEX_BYTES = {torch.uint32: 4, torch.uint64: 8}  # the layout's dtypes

_lib = None
_lib_lock = threading.Lock()


def _kernels():
    """The CUDA kernel library, built from csrc/ at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from dmlc_tpu_torch.native.build import build_kernels
            lib = ctypes.CDLL(build_kernels())
            args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                    ctypes.c_void_p]
            for fn in (lib.dmlc_csr_spmv, lib.dmlc_csr_spmv_t):
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def csr_row_ids(offset: torch.Tensor, nnz: int) -> torch.Tensor:
    """Row id of every nonzero: row_ids[k] = i s.t. offset[i] <= k < offset[i+1].

    Padded tail entries (k >= offset[-1]) map to row n (one past the last)
    so that segment sums can drop them.
    """
    k = torch.arange(nnz, dtype=offset.dtype, device=offset.device)
    return torch.searchsorted(offset, k, right=True) - 1


def _check_csr(offset, index, value, dense, dense_name):
    check(offset.dim() == 1 and offset.numel() >= 1
          and offset.dtype == torch.int64,
          f"offset must be 1-D int64 with >= 1 entry, got "
          f"{tuple(offset.shape)} {offset.dtype}")
    check(index.dtype in _INDEX_BYTES,
          f"index dtype must be uint32/uint64, got {index.dtype}")
    check(index.dim() == 1 and value.dim() == 1
          and index.numel() == value.numel(),
          f"index and value must be 1-D of one length, got "
          f"{tuple(index.shape)} and {tuple(value.shape)}")
    check(value.dtype == torch.float32 and dense.dtype == torch.float32,
          f"value and {dense_name} must be float32, got {value.dtype} and "
          f"{dense.dtype}")
    check(dense.dim() == 1, f"{dense_name} must be 1-D")
    devices = {t.device for t in (offset, index, value, dense)}
    check(len(devices) == 1,
          f"CSR tensors and {dense_name} must share one device, got "
          f"{sorted(str(d) for d in devices)}")


def _launch(fn, offset, index, value, dense, num_rows, num_features, out):
    for t in (offset, index, value, dense, out):
        check(t.is_contiguous(), "the CSR kernels need contiguous tensors")
    with torch.cuda.device(dense.device):
        stream = torch.cuda.current_stream(dense.device).cuda_stream
        err = fn(offset.data_ptr(), index.data_ptr(),
                 _INDEX_BYTES[index.dtype], value.data_ptr(),
                 dense.data_ptr(), num_rows, index.numel(), num_features,
                 out.data_ptr(), stream)
    if err != 0:
        raise DMLCError(f"{fn.__name__} launch failed: CUDA error {err}")


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
    idx = index.to(torch.int64)
    inside = (idx >= 0) & (idx < w.numel())
    gathered = torch.where(inside, w[torch.where(inside, idx, 0)],
                           float("nan"))
    y = torch.zeros(n + 1, dtype=w.dtype, device=w.device)
    y.index_add_(0, _segment_ids(offset, index.numel()), value * gathered)
    return y[:n]


def csr_spmv_t_plain(offset: torch.Tensor, index: torch.Tensor,
                     value: torch.Tensor, g: torch.Tensor,
                     num_features: int) -> torch.Tensor:
    """Plain version of K2: index_add_ of value·g[row] into grad_w."""
    rows = _segment_ids(offset, index.numel())
    idx = index.to(torch.int64)
    keep = (idx >= 0) & (idx < num_features)
    g_ext = torch.cat([g, g.new_zeros(1)])  # row n: the dropped tail
    contrib = torch.where(keep, value * g_ext[rows], 0.0)
    grad = torch.zeros(num_features, dtype=g.dtype, device=g.device)
    grad.index_add_(0, torch.where(keep, idx, 0), contrib)
    return grad


def csr_spmv(offset: torch.Tensor, index: torch.Tensor, value: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """K1: y[offset.numel()-1] = CSR · w (see module docstring)."""
    _check_csr(offset, index, value, w, "w")
    n = offset.numel() - 1
    if w.device.type == "cpu":
        return csr_spmv_plain(offset, index, value, w)
    check(w.is_cuda, f"csr_spmv runs on cuda or cpu, got {w.device}")
    y = torch.empty(n, dtype=torch.float32, device=w.device)
    _launch(_kernels().dmlc_csr_spmv, offset, index, value, w, n,
            w.numel(), y)
    csr_spmv.launches += 1
    return y


def csr_spmv_t(offset: torch.Tensor, index: torch.Tensor, value: torch.Tensor,
               g: torch.Tensor, num_features: int) -> torch.Tensor:
    """K2: grad_w[num_features] = CSRᵀ · g (see module docstring)."""
    _check_csr(offset, index, value, g, "g")
    n = offset.numel() - 1
    check(g.numel() == n, f"g must have one entry per row ({n}), "
          f"got {g.numel()}")
    if g.device.type == "cpu":
        return csr_spmv_t_plain(offset, index, value, g, num_features)
    check(g.is_cuda, f"csr_spmv_t runs on cuda or cpu, got {g.device}")
    grad = torch.zeros(num_features, dtype=torch.float32, device=g.device)
    _launch(_kernels().dmlc_csr_spmv_t, offset, index, value, g, n,
            num_features, grad)
    csr_spmv_t.launches += 1
    return grad


csr_spmv.launches = 0
csr_spmv_t.launches = 0


class _CSRSpMV(torch.autograd.Function):
    """y = CSR · w with K1 forward and K2 backward (gradient in w only:
    the CSR batch is data)."""

    @staticmethod
    def forward(ctx, offset, index, value, w):
        ctx.save_for_backward(offset, index, value)
        ctx.num_features = w.numel()
        return csr_spmv(offset, index, value, w)

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
