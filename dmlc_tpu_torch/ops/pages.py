"""The page tier's round unpack: one spilled round's raw bytes → the
padded ``[L, ...]`` batch, a CUDA kernel and its plain version.

A round of a spill file (``data/row_iter.py`` ``RoundSpillWriter``) is
``L`` RowBlock pages back to back, each array behind a header. Its
:class:`~dmlc_tpu_torch.data.row_iter.RoundTable` row (int64 ``[L,
len(ROUND_TABLE_COLUMNS)]``) says where each part's arrays lie, and
:func:`round_unpack` writes from those bytes the batch that
``data.padding.stack_padded_rows`` makes from the round's decoded blocks,
byte for byte: every key of ``stack_spec``, with ``qid`` and ``field``
where asked for (``want_qid``/``want_field``; a round whose blocks carry
one must ask for it).

``round_unpack`` launches ``csrc/pages.cu`` for CUDA tensors and counts
the launch in ``round_unpack.launches``; for CPU tensors it runs
:func:`round_unpack_plain`, the same function in numpy over the same
bytes. A :class:`RoundStage` call is a page epoch's round in one call:
the copy of its bytes from a pinned host slot to the card and the same
kernel, enqueued together by one C entry (``dmlc_round_stage``),
counted in ``round_unpack.launches`` too. Either writes a batch's keys
as views of one fresh allocation (:func:`unpack_layout`);
:func:`group_layout` places several rounds' batches in one, each view's
arguments worked out once for :meth:`RoundStage.batches`. It replaces no
TPU kernel: the reference pads a replayed round on the host
(``stack_padded_rows``).
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dmlc_tpu_torch.data.row_iter import ROUND_TABLE_COLUMNS
from dmlc_tpu_torch.ops.kernels import count, launch
from dmlc_tpu_torch.utils.logging import check

__all__ = ["round_unpack", "round_unpack_plain", "RoundStage",
           "unpack_spec", "unpack_layout", "group_layout", "GroupLayout",
           "INDEX_DTYPES"]

_C = {name: i for i, name in enumerate(ROUND_TABLE_COLUMNS)}
# the output index's dtype by its width in bytes
INDEX_DTYPES = {4: torch.uint32, 8: torch.uint64}
_NP_INDEX = {4: "<u4", 8: "<u8"}


def unpack_spec(parts: int, row_bucket: int, nnz_bucket: int,
                index_dtype: torch.dtype, want_qid: bool, want_field: bool
                ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """``{key: (shape, dtype)}`` of the batch ``round_unpack`` writes
    (``data.padding.stack_spec``'s, in torch dtypes)."""
    L, rb, nb = parts, row_bucket, nnz_bucket
    spec = {"offset": ((L, rb + 1), torch.int64),
            "label": ((L, rb), torch.float32),
            "weight": ((L, rb), torch.float32),
            "index": ((L, nb), index_dtype),
            "value": ((L, nb), torch.float32),
            "num_rows": ((L,), torch.int32),
            "num_nnz": ((L,), torch.int32)}
    if want_qid:
        spec["qid"] = ((L, rb), torch.int64)
    if want_field:
        spec["field"] = ((L, nb), torch.int64)
    return spec


# each key of a batch starts at a multiple of this many bytes of the
# batch's one allocation
ALIGN = 256


@functools.lru_cache(maxsize=64)
def unpack_layout(parts: int, row_bucket: int, nnz_bucket: int,
                  index_dtype: torch.dtype, want_qid: bool, want_field: bool
                  ) -> Tuple[Tuple[Tuple[str, int, int, tuple,
                                         torch.dtype], ...], int]:
    """Where each key of :func:`unpack_spec` lies in one byte buffer:
    ``((key, start, nbytes, shape, dtype), ...)`` in the spec's order,
    each start a multiple of ALIGN, and the buffer's total bytes."""
    keys, at = [], 0
    for k, (shape, dtype) in unpack_spec(parts, row_bucket, nnz_bucket,
                                         index_dtype, want_qid,
                                         want_field).items():
        n = int(np.prod(shape)) * dtype.itemsize
        keys.append((k, at, n, shape, dtype))
        at += (n + ALIGN - 1) // ALIGN * ALIGN
    return tuple(keys), at


class GroupLayout(NamedTuple):
    """Several rounds' batches placed in one byte buffer, each view's
    arguments worked out once (:func:`group_layout`)."""
    nbytes: int                  # the buffer's size
    dtypes: Tuple[torch.dtype, ...]  # each dtype a key of it has
    # a round's keys: (key, dtype, shape, stride, offset in elements of
    # dtype) each
    rounds: Tuple[Tuple[Tuple[str, torch.dtype, tuple, tuple, int], ...],
                  ...]


@functools.lru_cache(maxsize=256)
def group_layout(parts: int, row_bucket: int, nnz_bucket: int,
                 plans: Tuple[tuple, ...]) -> GroupLayout:
    """The rounds of ``plans`` (one ``(index_dtype, want_qid,
    want_field)`` a round) back to back in one byte buffer, each round
    placed by :func:`unpack_layout`: the buffer's size and, for each
    key, the dtype, shape, stride and element offset of its view."""
    rounds, at, dtypes = [], 0, {}
    for plan in plans:
        keys, total = unpack_layout(parts, row_bucket, nnz_bucket, *plan)
        views = []
        for k, a, _n, shape, dtype in keys:
            dtypes[dtype] = None
            views.append((k, dtype, shape,
                          (shape[1], 1) if len(shape) == 2 else (1,),
                          (at + a) // dtype.itemsize))
        rounds.append(tuple(views))
        at += total
    return GroupLayout(at, tuple(dtypes), tuple(rounds))


def _views(buf: torch.Tensor, layout: GroupLayout
           ) -> List[Dict[str, torch.Tensor]]:
    """The batches ``layout`` places, as views of the byte buffer ``buf``
    (its own allocation, at storage offset 0): one ``view`` of ``buf`` a
    dtype, then one ``as_strided`` of it a key."""
    bases = {dtype: buf.view(dtype) for dtype in layout.dtypes}
    return [{k: bases[dtype].as_strided(shape, stride, offset)
             for k, dtype, shape, stride, offset in keys}
            for keys in layout.rounds]


def _check_inputs(raw, table, index_dtype):
    check(raw.dtype == torch.uint8 and raw.dim() == 1
          and raw.is_contiguous(),
          f"round_unpack: raw must be contiguous 1-D uint8, got "
          f"{tuple(raw.shape)} {raw.dtype}")
    check(table.dtype == torch.int64 and table.dim() == 2
          and table.shape[1] == len(ROUND_TABLE_COLUMNS)
          and table.is_contiguous(),
          f"round_unpack: table must be contiguous int64 [parts, "
          f"{len(ROUND_TABLE_COLUMNS)}], got {tuple(table.shape)} "
          f"{table.dtype}")
    check(table.device == raw.device, "round_unpack: raw and table must "
          f"share one device, got {raw.device} and {table.device}")
    check(index_dtype in INDEX_DTYPES.values(),
          f"round_unpack: index dtype must be uint32 or uint64, got "
          f"{index_dtype}")


def _outputs(args, device, out):
    """Fresh tensors of ``unpack_spec(*args)`` on ``device``, views of
    one allocation placed by ``unpack_layout(*args)``, or ``out`` once it
    is checked to hold them."""
    if out is None:
        layout = group_layout(*args[:3], (args[3:],))
        return _views(torch.empty(layout.nbytes, dtype=torch.uint8,
                                  device=device), layout)[0]
    spec = unpack_spec(*args)
    check(out.keys() == spec.keys()
          and all(tuple(out[k].shape) == shape and out[k].dtype == dtype
                  and out[k].device == device and out[k].is_contiguous()
                  for k, (shape, dtype) in spec.items()),
          f"round_unpack: out= does not hold the round's unpack_spec on "
          f"{device}")
    return out


def round_unpack(raw: torch.Tensor, table: torch.Tensor, row_bucket: int,
                 nnz_bucket: int, index_dtype: torch.dtype,
                 want_qid: bool = False, want_field: bool = False,
                 out: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
    """The padded batch of the round whose bytes are ``raw`` (uint8, at
    least the round's size) and whose table rows are ``table``, into
    fresh tensors on ``raw``'s device or into ``out`` (tensors of
    :func:`unpack_spec`'s shapes and dtypes there). For CUDA tensors the
    caller has checked each part's n and nnz against the buckets (it
    holds the table on the host); the plain version checks them."""
    _check_inputs(raw, table, index_dtype)
    if raw.device.type == "cpu":
        return round_unpack_plain(raw, table, row_bucket, nnz_bucket,
                                  index_dtype, want_qid, want_field, out)
    check(raw.is_cuda, f"round_unpack runs on cuda or cpu, got {raw.device}")
    args = (table.shape[0], row_bucket, nnz_bucket, index_dtype, want_qid,
            want_field)
    out = _outputs(args, raw.device, out)
    launch("dmlc_round_unpack", raw.device, raw.data_ptr(), table.data_ptr(),
           table.shape[0], row_bucket, nnz_bucket, index_dtype.itemsize,
           *_pointers(out))
    count(round_unpack)
    return out


def _pointers(out):
    """The output pointers in the C entries' order (None: not asked
    for)."""
    return [out[k].data_ptr() if k in out else None
            for k in ("offset", "label", "weight", "index", "value", "qid",
                      "field", "num_rows", "num_nnz")]


class RoundStage:
    """A page epoch's rounds, one call each, the per-epoch part checked
    once. ``dev_raw`` is a uint8 buffer of at least the largest round,
    ``table`` the epoch's round table (int64 ``[rounds, parts,
    len(ROUND_TABLE_COLUMNS)]``, or one round's ``[parts, ...]``) on the
    same device, and ``stream`` the stream every call enqueues on (the
    current one at construction when None).

    Calling it with round ``r``'s bytes (1-D uint8 on the CPU, pinned for
    an asynchronous copy) copies them into the head of ``dev_raw`` and
    writes the batch :func:`round_unpack` writes from them, in one fresh
    allocation made on ``stream`` (views placed by :func:`unpack_layout`)
    or in ``out``. On the card one C call, ``dmlc_round_stage``,
    enqueues both the copy and the ``round_unpack`` launch, counted in
    ``round_unpack.launches``; the caller records the event that
    releases the host bytes. On the CPU the copy is ``copy_`` and the
    unpack :func:`round_unpack_plain`. The caller has checked each
    part's n and nnz against the buckets, as for :func:`round_unpack`.
    :meth:`outputs` makes several rounds' ``out`` in one allocation."""

    def __init__(self, dev_raw: torch.Tensor, table: torch.Tensor,
                 row_bucket: int, nnz_bucket: int, stream=None):
        check(dev_raw.dtype == torch.uint8 and dev_raw.dim() == 1
              and dev_raw.is_contiguous(),
              f"RoundStage: dev_raw must be contiguous 1-D uint8, got "
              f"{tuple(dev_raw.shape)} {dev_raw.dtype}")
        if table.dim() == 2:
            table = table.unsqueeze(0)
        check(table.dim() == 3 and table.is_contiguous()
              and table.shape[2] == len(ROUND_TABLE_COLUMNS),
              f"RoundStage: table must be contiguous [rounds, parts, "
              f"{len(ROUND_TABLE_COLUMNS)}], got {tuple(table.shape)}")
        _check_inputs(dev_raw, table.view(-1, len(ROUND_TABLE_COLUMNS)),
                      torch.uint32)
        self.device = dev_raw.device
        self.dev_raw, self.table = dev_raw, table
        self.rounds, self.parts = table.shape[0], table.shape[1]
        self.row_bucket, self.nnz_bucket = row_bucket, nnz_bucket
        if self.device.type == "cpu":
            return
        check(self.device.type == "cuda",
              f"RoundStage runs on cuda or cpu, got {self.device}")
        self.stream = (stream if stream is not None
                       else torch.cuda.current_stream(self.device))
        self._table_ptr = table.data_ptr()
        self._row_bytes = table[0].numel() * table.element_size() \
            if len(table) else 0

    def outputs(self, plans: Sequence[tuple]) -> List[Dict[str, torch.Tensor]]:
        """Fresh batches for several rounds in one allocation (on
        ``stream``), each ``(index_dtype, want_qid, want_field)`` of
        ``plans`` a dict of :func:`unpack_spec`'s keys, each key at a
        multiple of ALIGN: :meth:`batches` of their
        :func:`group_layout`."""
        return self.batches(group_layout(self.parts, self.row_bucket,
                                         self.nnz_bucket, tuple(plans)))

    def batches(self, layout: GroupLayout, nbytes: int = 0
                ) -> List[Dict[str, torch.Tensor]]:
        """The batches ``layout`` (a :func:`group_layout` of this stage's
        parts and buckets) places, in one fresh allocation of
        ``layout.nbytes``, or ``nbytes`` where that is more, made on
        ``stream``. A consumer that keeps one keeps the allocation."""
        n = max(layout.nbytes, nbytes)
        if self.device.type == "cuda" and \
                torch.cuda.current_stream(self.device) != self.stream:
            with torch.cuda.stream(self.stream):
                buf = torch.empty(n, dtype=torch.uint8, device=self.device)
        else:
            buf = torch.empty(n, dtype=torch.uint8, device=self.device)
        return _views(buf, layout)

    def __call__(self, host: torch.Tensor, r: int, index_dtype: torch.dtype,
                 want_qid: bool = False, want_field: bool = False,
                 at: int = 0, nbytes: Optional[int] = None,
                 out: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
        """Round ``r`` from ``host[at:at + nbytes]`` (all of ``host`` past
        ``at`` when ``nbytes`` is None), into ``out`` (one of
        :meth:`outputs`' batches for this round's plan) or fresh
        tensors."""
        check(host.device.type == "cpu" and host.dtype == torch.uint8
              and host.dim() == 1 and host.is_contiguous(),
              f"RoundStage: host must be contiguous 1-D uint8 on the cpu, "
              f"got {tuple(host.shape)} {host.dtype} on {host.device}")
        check(0 <= r < self.rounds, f"RoundStage: round {r} is not one of "
              f"the table's {self.rounds}")
        n = host.numel() - at if nbytes is None else nbytes
        check(0 <= at and at + n <= host.numel()
              and n <= self.dev_raw.numel(),
              f"RoundStage: a round of {n} bytes at {at} of a host buffer "
              f"of {host.numel()} does not fit it or dev_raw's "
              f"{self.dev_raw.numel()}")
        rb, nb = self.row_bucket, self.nnz_bucket
        if self.device.type == "cpu":
            self.dev_raw[:n].copy_(host[at:at + n])
            return round_unpack_plain(self.dev_raw[:n], self.table[r], rb,
                                      nb, index_dtype, want_qid, want_field,
                                      out)
        if out is None:
            out = self.outputs([(index_dtype, want_qid, want_field)])[0]
        launch("dmlc_round_stage", self.device, host.data_ptr() + at,
               self.dev_raw.data_ptr(), n,
               self._table_ptr + r * self._row_bytes, self.parts, rb, nb,
               index_dtype.itemsize, *_pointers(out), stream=self.stream)
        count(round_unpack)
        return out


def round_unpack_plain(raw: torch.Tensor, table: torch.Tensor,
                       row_bucket: int, nnz_bucket: int,
                       index_dtype: torch.dtype, want_qid: bool = False,
                       want_field: bool = False,
                       out: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, torch.Tensor]:
    """:func:`round_unpack` in numpy over CPU tensors: each array read
    where the table places it (``np.frombuffer`` reads at any byte),
    written into its part's row, then the neutral tail, as
    ``stack_padded_rows`` writes them. The outputs own their memory (one
    allocation, as the kernel's): none aliases ``raw``."""
    rb, nb = row_bucket, nnz_bucket
    _check_inputs(raw, table, index_dtype)
    args = (table.shape[0], rb, nb, index_dtype, want_qid, want_field)
    out = _outputs(args, raw.device, out)
    buf = raw.numpy()
    o = {k: v.numpy() for k, v in out.items()}
    for i, t in enumerate(table.numpy()):
        n, nnz = int(t[_C["n"]]), int(t[_C["nnz"]])
        check(n <= rb, "row bucket too small")
        check(nnz <= nb, "nnz bucket too small")
        check((want_qid or t[_C["qid"]] < 0)
              and (want_field or t[_C["field"]] < 0),
              "round_unpack: a block carries qid or field the call did not "
              "ask for")

        def arr(name, dtype, count):
            return np.frombuffer(buf, dtype, count, int(t[_C[name]]))

        def opt(name, dtype, count, absent):
            return arr(name, dtype, count) if t[_C[name]] >= 0 else absent

        o["offset"][i, :n + 1] = arr("offset", "<i8", n + 1)
        o["offset"][i, n + 1:] = nnz
        o["label"][i, :n] = arr("label", "<f4", n)
        o["label"][i, n:] = 0.0
        o["weight"][i, :n] = opt("weight", "<f4", n, 1.0)
        o["weight"][i, n:] = 0.0
        o["index"][i, :nnz] = arr("index", _NP_INDEX[int(
            t[_C["index_bytes"]])], nnz)
        o["index"][i, nnz:] = 0
        o["value"][i, :nnz] = opt("value", "<f4", nnz, 1.0)
        o["value"][i, nnz:] = 0.0
        o["num_rows"][i] = n
        o["num_nnz"][i] = nnz
        if want_qid:
            o["qid"][i, :n] = opt("qid", "<i8", n, -1)
            o["qid"][i, n:] = -1
        if want_field:
            o["field"][i, :nnz] = opt("field", "<i8", nnz, 0)
            o["field"][i, nnz:] = 0
    return out


round_unpack.launches = 0
