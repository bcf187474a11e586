"""The factorization machines' pair terms: CUDA kernels and plain versions.

Counterpart of the pair terms of ``dmlc_tpu/models/fm.py:43``
``_fm_margins`` (FM) and ``:117`` ``_ffm_margins`` (field-aware FM),
and of their gradients in V, which XLA compiled from jnp there. Here each
is a CUDA kernel written by hand (``csrc/fm.cu``) with a plain PyTorch
version of the same function beside it:

- K5 ``fm_pair_fwd``:  s[r,:] = Σ_k x_k V[i_k,:], sq[r,:] = Σ_k (x_k V[i_k,:])²,
  pair[r] = ½ Σ_f (s² − sq); returns (pair, s)
- K5 ``fm_pair_bwd``:  gV[i_k,:] += g[r]·x_k·(s[r,:] − x_k V[i_k,:])
- K6 ``ffm_pair_fwd``: S[r,a,b,:] = Σ_{k: f_k=a} x_k V[i_k,b,:],
  pair[r] = ½ (Σ_{a,b} ⟨S[r,a,b],S[r,b,a]⟩ − Σ_k ‖x_k V[i_k,f_k,:]‖²)
- K6 ``ffm_pair_bwd``: gV[i_k,b,:] += g[r]·x_k·(S[r,b,f_k,:] − [b=f_k]·x_k V[i_k,f_k,:])

(k runs over the nonzeros of row r, x is ``value``, i is ``index``, f is
``field`` clipped into [0, num_fields − 1] after taking its low 32
bits, signed, as the reference's ``astype(int32)`` does.) ``fm_pair`` and ``ffm_pair``
pair each forward with its backward in a ``torch.autograd.Function``,
differentiable in V only.

As in ``ops/csr.py``: a wrapper runs the plain version only when its
tensors lie on the CPU, and for CUDA tensors launches its kernel or
raises (K5 forward and backward by the route :func:`fm_route` picks, K6
by :func:`ffm_route`'s); each wrapper counts its launches in
``.launches``. An index maps
by the reference's rule (``ops/index.py``), and an invalid one reads as
NaN factors (``jnp.take`` fills NaN), so its row's pair
is NaN and the gradient is NaN wherever the reference's is; the
out-of-range nonzero itself adds nothing to gV. Nonzeros past
``offset[-1]`` (the padded tail) belong to no row. The plain versions
materialise what the kernels do not (FFM's ``[nnz, nf, K]`` gather and
``[rows, nf, nf, K]`` S): they are for the tests and for holding the
kernels to them on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dmlc_tpu_torch.ops.csr import _check_csr, _segment_ids
from dmlc_tpu_torch.ops.index import clip_field, wrap_index
from dmlc_tpu_torch.ops.kernels import (
    INDEX_BYTES, count, launch, max_shared_bytes,
)
from dmlc_tpu_torch.utils.logging import check

__all__ = ["fm_pair", "ffm_pair", "fm_pair_fwd", "fm_pair_bwd",
           "ffm_pair_fwd", "ffm_pair_bwd", "fm_pair_fwd_plain",
           "fm_pair_bwd_plain", "ffm_pair_fwd_plain", "ffm_pair_bwd_plain",
           "ffm_route", "fm_route", "starts_aligned"]


# ------------------------------------------------------------ plain versions

def _gather(V: torch.Tensor, index: torch.Tensor):
    """V[index] with NaN rows where the index is invalid (the reference's
    filled take), the rows read (0 where invalid) and the valid mask."""
    idx, inside = wrap_index(index, V.shape[0])
    mask = inside.view((-1,) + (1,) * (V.dim() - 1))
    return torch.where(mask, V[idx], float("nan")), idx, inside


def _with_tail(t: torch.Tensor) -> torch.Tensor:
    """t with one zero row appended: the row the padded tail maps to."""
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


def fm_pair_fwd_plain(offset, index, value, V) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Plain version of K5 forward: gather, then index_add_ over rows."""
    n, K = offset.numel() - 1, V.shape[1]
    seg = _segment_ids(offset, index.numel())
    vx = value[:, None] * _gather(V, index)[0]
    s = V.new_zeros(n + 1, K).index_add_(0, seg, vx)[:n]
    sq = V.new_zeros(n + 1, K).index_add_(0, seg, vx * vx)[:n]
    return 0.5 * (s * s - sq).sum(-1), s


def fm_pair_bwd_plain(offset, index, value, V, s, g) -> torch.Tensor:
    """Plain version of K5 backward: index_add_ of the per-nonzero
    gradients into gV."""
    seg = _segment_ids(offset, index.numel())
    v, idx, keep = _gather(V, index)
    x = value[:, None]
    d = _with_tail(g)[seg][:, None] * x * (_with_tail(s)[seg] - x * v)
    return torch.zeros_like(V).index_add_(
        0, idx, torch.where(keep[:, None], d, 0.0))


def _ffm_S(offset, index, value, field, V):
    """Per-nonzero row ids, clipped fields, x·V[i] [nnz, nf, K] and
    S [rows + 1, nf, nf, K] (the last row sums the padded tail)."""
    n, nf, K = offset.numel() - 1, V.shape[1], V.shape[2]
    seg = _segment_ids(offset, index.numel())
    f = clip_field(field, nf)
    v, idx, keep = _gather(V, index)
    vx = value[:, None, None] * v
    S = V.new_zeros((n + 1) * nf, nf, K).index_add_(0, seg * nf + f, vx)
    return seg, f, vx, S.view(n + 1, nf, nf, K), idx, keep


def ffm_pair_fwd_plain(offset, index, value, field, V) -> torch.Tensor:
    """Plain version of K6 forward: the reference's segment sum over
    (row, own field) and einsum, with the diagonal taken off entry by
    entry as the kernel does: ½ (Σ_{a≠b} ⟨S[a,b],S[b,a]⟩ + Σ_a (‖S[a,a]‖²
    − D[a])), where D[a] sums the squares of field a's own x·V[i, a].
    A row of one nonzero then gets a pair of exactly 0."""
    n, nf, K = offset.numel() - 1, V.shape[1], V.shape[2]
    seg, f, vx, S, _, _ = _ffm_S(offset, index, value, field, V)
    S = S[:n]
    eye = torch.eye(nf, dtype=torch.bool, device=V.device)[None, :, :, None]
    cross = torch.einsum("nabk,nbak->n", torch.where(eye, 0.0, S), S)
    vsel = vx[torch.arange(vx.shape[0], device=vx.device), f]  # [nnz, K]
    D = V.new_zeros((n + 1) * nf, K).index_add_(0, seg * nf + f,
                                                 vsel * vsel)
    own = S.diagonal(dim1=1, dim2=2).transpose(1, 2)  # [n, nf, K]
    return 0.5 * (cross + (own * own - D[:n * nf].view(n, nf, K)).sum((1, 2)))


def ffm_pair_bwd_plain(offset, index, value, field, V, g) -> torch.Tensor:
    """Plain version of K6 backward: S rebuilt, S[r, :, f_k, :] gathered
    per nonzero, the diagonal's own term taken off, index_add_ into gV.
    The padded tail's nonzeros are dropped with the invalid ones: their
    row of S sums the tail, NaN where a tail index is invalid, and
    0 · NaN would reach gV (ROADMAP C7)."""
    n, nf = offset.numel() - 1, V.shape[1]
    seg, f, vx, S, idx, keep = _ffm_S(offset, index, value, field, V)
    d = S[seg, :, f]  # [nnz, nf (b), K] = S[r, b, f_k, :]
    own = torch.nn.functional.one_hot(f, nf).to(V.dtype)[:, :, None]
    vsel = vx[torch.arange(vx.shape[0], device=vx.device), f]
    d = d - own * vsel[:, None, :]
    contrib = (_with_tail(g)[seg] * value)[:, None, None] * d
    return torch.zeros_like(V).index_add_(
        0, idx, torch.where((keep & (seg < n))[:, None, None], contrib, 0.0))


# ------------------------------------------------------------ wrappers

def _check(offset, index, value, V, dims, field=None, s=None, g=None):
    """Checks a call's tensors; returns (rows, whether to launch the
    kernel). s [rows, K] and g [rows] are the backward's inputs."""
    _check_csr(offset, index, value, V, "V", dense_dim=dims)
    check(all(d > 0 for d in V.shape[1:]),
          f"V must have factors (and fields), got shape {tuple(V.shape)}")
    n = offset.numel() - 1
    for name, t, shape in (("s", s, (n, V.shape[-1])), ("g", g, (n,))):
        if t is not None:
            check(tuple(t.shape) == shape and t.dtype == torch.float32
                  and t.device == V.device,
                  f"{name} must be float32 {shape} on {V.device}, got "
                  f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if field is not None:
        check(field.dtype == torch.int64 and field.dim() == 1
              and field.numel() == index.numel()
              and field.device == V.device,
              f"field must be int64 [{index.numel()}] on {V.device}, got "
              f"{field.dtype} {tuple(field.shape)} on {field.device}")
    if V.device.type == "cpu":
        return n, False
    check(V.is_cuda, f"the FM kernels run on cuda or cpu, got {V.device}")
    for t in (offset, index, value, V, field, s, g):
        check(t is None or t.is_contiguous(),
              "the FM kernels need contiguous tensors")
    return n, True


def fm_pair_fwd(offset: torch.Tensor, index: torch.Tensor,
                value: torch.Tensor, V: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 forward: (pair [rows], s [rows, K]) for V [F, K]."""
    n, on_card = _check(offset, index, value, V, 2)
    if not on_card:
        return fm_pair_fwd_plain(offset, index, value, V)
    F, K = V.shape
    check(index.numel() < 2**31 and n < 2**31 - 1,
          f"fm_pair_fwd takes fewer than 2^31 nonzeros and rows, got "
          f"{index.numel()} and {n}")
    pair = torch.empty(n, dtype=torch.float32, device=V.device)
    s = torch.empty(n, K, dtype=torch.float32, device=V.device)
    aligned = starts_aligned(V, s)
    launch("dmlc_fm_pair_fwd", V.device, offset.data_ptr(), index.data_ptr(),
           INDEX_BYTES[index.dtype], value.data_ptr(), V.data_ptr(), n,
           index.numel(), F, K, pair.data_ptr(), s.data_ptr(),
           int(fm_route(K, aligned) == "vector"))
    count(fm_pair_fwd)
    return pair, s


def fm_pair_bwd(offset: torch.Tensor, index: torch.Tensor,
                value: torch.Tensor, V: torch.Tensor, s: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """K5 backward: gV [F, K] for the cotangent g [rows] of the pair, with
    s from the forward."""
    n, on_card = _check(offset, index, value, V, 2, s=s, g=g)
    if not on_card:
        return fm_pair_bwd_plain(offset, index, value, V, s, g)
    F, K = V.shape
    gV = torch.zeros_like(V)
    aligned = starts_aligned(V, s, gV)
    launch("dmlc_fm_pair_bwd", V.device, offset.data_ptr(), index.data_ptr(),
           INDEX_BYTES[index.dtype], value.data_ptr(), V.data_ptr(),
           s.data_ptr(), g.data_ptr(), n, index.numel(), F, K,
           gV.data_ptr(), int(fm_route(K, aligned) == "vector"))
    count(fm_pair_bwd)
    return gV


def starts_aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's data starts on 16 bytes (a float4)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def fm_route(K: int, aligned: bool) -> str:
    """K5's route, forward and backward: ``"vector"`` (four factors a
    lane: float4 loads of V, and of s and one vector reduction into gV in
    the backward) where K % 4 == 0 and the call's tensors of K columns (V
    and s; and gV in the backward) start on 16 bytes (``aligned``), so
    that every row's factors do; else ``"scalar"`` (one factor a lane)."""
    return "vector" if K % 4 == 0 and aligned else "scalar"


# The global route's workspace: at most this many bytes, and two blocks an
# SM (each block holds one row's S and D at a time).
FFM_WORKSPACE_BYTES = 256 << 20
FFM_BLOCKS_PER_SM = 2
# A K6 block's static shared memory (kStaticSharedBytes of csrc/fm.cu,
# which asserts this value): its staged nonzeros and reduction scratch.
FFM_STATIC_SHARED_BYTES = 1056


def ffm_shared_bytes(num_fields: int, K: int) -> int:
    """Bytes of one row's S [nf, nf, K] and D [nf, K]."""
    return (num_fields * num_fields * K + num_fields * K) * 4


def ffm_route(num_fields: int, K: int, max_shared: int) -> str:
    """K6's route for S and D: ``"shared"`` where they fit a block's
    ``max_shared`` bytes of shared memory, else ``"global"`` (a workspace
    in device memory)."""
    return ("shared" if ffm_shared_bytes(num_fields, K) <= max_shared
            else "global")


def _ffm_workspace(V: torch.Tensor, rows: int):
    """(workspace or None, blocks) of a K6 call: None for the shared
    route; for the global route min(rows, FFM_BLOCKS_PER_SM · SMs, what
    FFM_WORKSPACE_BYTES holds) blocks, at least one, each with one row's
    S and D. A workspace that cannot be had raises the allocator's
    out-of-memory error."""
    _, nf, K = V.shape
    most = max_shared_bytes(V.device) - FFM_STATIC_SHARED_BYTES
    if ffm_route(nf, K, most) == "shared":
        return None, 0
    per_block = ffm_shared_bytes(nf, K)
    sms = torch.cuda.get_device_properties(V.device).multi_processor_count
    blocks = max(1, min(rows, FFM_BLOCKS_PER_SM * sms,
                        FFM_WORKSPACE_BYTES // per_block))
    return torch.empty(blocks * per_block // 4, dtype=torch.float32,
                       device=V.device), blocks


def ffm_pair_fwd(offset: torch.Tensor, index: torch.Tensor,
                 value: torch.Tensor, field: torch.Tensor,
                 V: torch.Tensor) -> torch.Tensor:
    """K6 forward: pair [rows] for V [F, num_fields, K]."""
    n, on_card = _check(offset, index, value, V, 3, field=field)
    if not on_card:
        return ffm_pair_fwd_plain(offset, index, value, field, V)
    F, nf, K = V.shape
    workspace, blocks = _ffm_workspace(V, n)
    pair = torch.empty(n, dtype=torch.float32, device=V.device)
    launch("dmlc_ffm_pair_fwd", V.device, offset.data_ptr(),
           index.data_ptr(), INDEX_BYTES[index.dtype], value.data_ptr(),
           field.data_ptr(), V.data_ptr(), n, index.numel(), F, nf, K,
           pair.data_ptr(),
           None if workspace is None else workspace.data_ptr(), blocks)
    count(ffm_pair_fwd)
    return pair


def ffm_pair_bwd(offset: torch.Tensor, index: torch.Tensor,
                 value: torch.Tensor, field: torch.Tensor, V: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    """K6 backward: gV [F, num_fields, K] for the cotangent g [rows]."""
    n, on_card = _check(offset, index, value, V, 3, field=field, g=g)
    if not on_card:
        return ffm_pair_bwd_plain(offset, index, value, field, V, g)
    F, nf, K = V.shape
    workspace, blocks = _ffm_workspace(V, n)
    gV = torch.zeros_like(V)
    launch("dmlc_ffm_pair_bwd", V.device, offset.data_ptr(),
           index.data_ptr(), INDEX_BYTES[index.dtype], value.data_ptr(),
           field.data_ptr(), V.data_ptr(), g.data_ptr(), n, index.numel(),
           F, nf, K, gV.data_ptr(),
           None if workspace is None else workspace.data_ptr(), blocks)
    count(ffm_pair_bwd)
    return gV


fm_pair_fwd.launches = 0
fm_pair_bwd.launches = 0
ffm_pair_fwd.launches = 0
ffm_pair_bwd.launches = 0


class _FMPair(torch.autograd.Function):
    """pair = the FM pair term, with K5 forward and K5 backward (gradient
    in V only: the CSR batch is data)."""

    @staticmethod
    def forward(ctx, offset, index, value, V):
        pair, s = fm_pair_fwd(offset, index, value, V)
        ctx.save_for_backward(offset, index, value, V, s)
        return pair

    @staticmethod
    def backward(ctx, g):
        offset, index, value, V, s = ctx.saved_tensors
        gV = None
        if ctx.needs_input_grad[3]:
            gV = fm_pair_bwd(offset, index, value, V, s, g.contiguous())
        return None, None, None, gV


class _FFMPair(torch.autograd.Function):
    """pair = the FFM pair term, with K6 forward and K6 backward
    (gradient in V only)."""

    @staticmethod
    def forward(ctx, offset, index, value, field, V):
        ctx.save_for_backward(offset, index, value, field, V)
        return ffm_pair_fwd(offset, index, value, field, V)

    @staticmethod
    def backward(ctx, g):
        offset, index, value, field, V = ctx.saved_tensors
        gV = None
        if ctx.needs_input_grad[4]:
            gV = ffm_pair_bwd(offset, index, value, field, V, g.contiguous())
        return None, None, None, None, gV


def fm_pair(offset: torch.Tensor, index: torch.Tensor, value: torch.Tensor,
            V: torch.Tensor) -> torch.Tensor:
    """The FM pair term per row, differentiable in V [F, K]."""
    return _FMPair.apply(offset, index, value, V)


def ffm_pair(offset: torch.Tensor, index: torch.Tensor, value: torch.Tensor,
             field: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """The FFM pair term per row, differentiable in V [F, num_fields, K]."""
    return _FFMPair.apply(offset, index, value, field, V)
