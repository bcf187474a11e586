"""CSR batch type: RowBlock / Row / RowBlockContainer.

Reference: include/dmlc/data.h — RowBlock<IndexType> (size, offset[],
label[], weight[], qid[], field[], index[], value[]), Row<I> (view, get(i),
SDot), and src/data/row_block.h — RowBlockContainer<I> (Push/Clear/GetBlock/
Save/Load/max_index).

Deltas from the reference:
- Arrays are numpy (host) and move to a torch device via
  ``RowBlock.to_device``. dtypes: offset int64, label/weight/value float32,
  qid int64, field int64, index uint32 or uint64 (IndexType parameter).
- ``value`` may be None (implicit 1.0), as in the reference.
- The on-disk page format (``save_block``/``load_block``) is the
  reference's own little-endian format, same magic, version and flag
  bits, so a page written by one package is byte-identical to the
  other's and loads in it.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from dmlc_tpu_torch.io.stream import Stream
from dmlc_tpu_torch.utils import serializer as ser
from dmlc_tpu_torch.utils.logging import check, check_eq, check_lt

__all__ = ["RowBlock", "Row", "RowBlockContainer"]

_PAGE_MAGIC = 0x42524F57  # "BROW"
_PAGE_VERSION = 1


class Row:
    """One sparse row view (reference: Row<I>)."""

    __slots__ = ("label", "weight", "qid", "index", "value", "field")

    def __init__(self, label, weight, qid, index, value, field):
        self.label = label
        self.weight = weight
        self.qid = qid
        self.index = index      # np view, len = nnz
        self.value = value      # np view or None (implicit 1.0)
        self.field = field      # np view or None

    @property
    def length(self) -> int:
        return len(self.index)

    def get_value(self, i: int):
        """value[i] or implicit 1.0 (reference: Row::get_value)."""
        return np.float32(1.0) if self.value is None else self.value[i]

    def sdot(self, weight: np.ndarray) -> float:
        """Sparse dot with a dense weight vector (reference: Row::SDot)."""
        idx = self.index.astype(np.int64, copy=False)
        if self.value is None:
            return float(weight[idx].sum())
        return float((weight[idx] * self.value).sum())


class RowBlock:
    """Immutable CSR batch (reference: RowBlock<IndexType>).

    ``lease`` is non-None when the arrays are zero-copy views into a
    native-engine arena (native.bindings.BlockLease): the block
    is then EPHEMERAL — valid until the producing parser's next
    next()/before_first(), the reference's RowBlock lifetime contract.
    Consumers that retain data past that point must ``copy()`` (the
    RowBlockContainer does this automatically).
    """

    __slots__ = ("offset", "label", "weight", "qid", "field", "index",
                 "value", "lease", "max_index")

    def __init__(self, offset: np.ndarray, label: np.ndarray,
                 index: np.ndarray, value: Optional[np.ndarray] = None,
                 weight: Optional[np.ndarray] = None,
                 qid: Optional[np.ndarray] = None,
                 field: Optional[np.ndarray] = None,
                 max_index: Optional[int] = None):
        offset = np.asarray(offset, dtype=np.int64)
        check(offset.ndim == 1 and len(offset) >= 1, "offset must be 1-D, len>=1")
        size = len(offset) - 1
        self.offset = offset
        self.label = np.asarray(label, dtype=np.float32)
        check_eq(len(self.label), size, "label length mismatch")
        nnz = int(offset[-1])
        self.index = np.asarray(index)
        check(self.index.dtype in (np.uint32, np.uint64),
              f"index dtype must be uint32/uint64, got {self.index.dtype}")
        check_eq(len(self.index), nnz, "index length mismatch")
        self.value = None if value is None else np.asarray(value, np.float32)
        if self.value is not None:
            check_eq(len(self.value), nnz, "value length mismatch")
        self.weight = None if weight is None else np.asarray(weight, np.float32)
        if self.weight is not None:
            check_eq(len(self.weight), size, "weight length mismatch")
        self.qid = None if qid is None else np.asarray(qid, np.int64)
        if self.qid is not None:
            check_eq(len(self.qid), size, "qid length mismatch")
        self.field = None if field is None else np.asarray(field, np.int64)
        if self.field is not None:
            check_eq(len(self.field), nnz, "field length mismatch")
        self.lease = None
        # optional producer-supplied metadata: max feature index in this
        # block (the native engine computes it during parse); None means
        # "unknown — rescan if you need it"
        self.max_index = max_index

    @property
    def size(self) -> int:
        return len(self.offset) - 1

    @property
    def nnz(self) -> int:
        return int(self.offset[-1])

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, i: int) -> Row:
        check_lt(i, self.size, "row index out of range")
        lo, hi = int(self.offset[i]), int(self.offset[i + 1])
        return Row(
            label=self.label[i],
            weight=self.weight[i] if self.weight is not None else np.float32(1.0),
            qid=int(self.qid[i]) if self.qid is not None else -1,
            index=self.index[lo:hi],
            value=self.value[lo:hi] if self.value is not None else None,
            field=self.field[lo:hi] if self.field is not None else None)

    def __iter__(self) -> Iterator[Row]:
        for i in range(self.size):
            yield self[i]

    def slice(self, begin: int, end: int) -> "RowBlock":
        """Sub-block view [begin, end) (reference: RowBlock::Slice)."""
        check(0 <= begin <= end <= self.size, "bad slice range")
        base = int(self.offset[begin])
        lo, hi = base, int(self.offset[end])
        out = RowBlock(
            offset=self.offset[begin:end + 1] - base,
            label=self.label[begin:end],
            index=self.index[lo:hi],
            value=self.value[lo:hi] if self.value is not None else None,
            weight=self.weight[begin:end] if self.weight is not None else None,
            qid=self.qid[begin:end] if self.qid is not None else None,
            field=self.field[lo:hi] if self.field is not None else None)
        out.lease = self.lease  # a slice of an ephemeral block is ephemeral
        return out

    def copy(self) -> "RowBlock":
        """Deep copy with owned arrays (detaches from any native lease)."""
        return RowBlock(
            offset=self.offset.copy(),
            label=self.label.copy(),
            index=self.index.copy(),
            value=self.value.copy() if self.value is not None else None,
            weight=self.weight.copy() if self.weight is not None else None,
            qid=self.qid.copy() if self.qid is not None else None,
            field=self.field.copy() if self.field is not None else None,
            max_index=self.max_index)

    def memory_cost_bytes(self) -> int:
        """Reference: RowBlock::MemCostBytes."""
        cost = self.offset.nbytes + self.label.nbytes + self.index.nbytes
        for a in (self.value, self.weight, self.qid, self.field):
            if a is not None:
                cost += a.nbytes
        return cost

    def content_hash(self) -> str:
        """Order-sensitive hash of all CSR content — the byte-parity probe
        used by BASELINE's "CSR byte-identical" criterion."""
        import hashlib
        h = hashlib.sha256()
        for name in ("offset", "label", "weight", "qid", "field", "index",
                     "value"):
            a = getattr(self, name)
            h.update(name.encode())
            if a is None:
                h.update(b"<none>")
            else:
                h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    def to_device(self, device=None):
        """Move the CSR arrays to a torch device (``cuda`` by default) as
        a dict of tensors. The index keeps its layout dtype (u32/u64):
        the kernels read it as it is."""
        import torch
        device = torch.device("cuda" if device is None else device)
        out = {"offset": self.offset, "label": self.label,
               "index": self.index}
        for name in ("value", "weight", "qid", "field"):
            a = getattr(self, name)
            if a is not None:
                out[name] = a
        # torch.tensor copies: a leased native-arena view must not be
        # aliased by the result, whatever the device
        return {k: torch.tensor(v, device=device) for k, v in out.items()}


class RowBlockContainer:
    """Growable owning CSR builder (reference: RowBlockContainer<I>)."""

    def __init__(self, index_dtype=np.uint32):
        check(np.dtype(index_dtype) in (np.dtype(np.uint32), np.dtype(np.uint64)),
              "index_dtype must be uint32/uint64")
        self.index_dtype = np.dtype(index_dtype)
        self.clear()

    def clear(self) -> None:
        # Row-wise fields live in two tiers: cheap Python "slab" lists fed
        # by per-row push() (the Python-engine hot path), and ndarray
        # chunks fed by push_block() (the native-engine drain path — must
        # never box rows). get_block() flushes slabs and concatenates.
        self._nrows = 0
        self._s_len: List[int] = []
        self._s_label: List[float] = []
        self._s_weight: List[float] = []
        self._s_qid: List[int] = []
        self._c_len: List[np.ndarray] = []
        self._c_label: List[np.ndarray] = []
        self._c_weight: List[Optional[np.ndarray]] = []
        self._c_qid: List[Optional[np.ndarray]] = []
        self._index: List[np.ndarray] = []
        self._value: List[Optional[np.ndarray]] = []
        self._field: List[Optional[np.ndarray]] = []
        self._has_value = False
        self._has_weight = False
        self._has_qid = False
        self._has_field = False
        self.max_index = 0

    @property
    def size(self) -> int:
        return self._nrows

    def _flush_slabs(self) -> None:
        if not self._s_len:
            return
        self._c_len.append(np.asarray(self._s_len, np.int64))
        self._c_label.append(np.asarray(self._s_label, np.float32))
        self._c_weight.append(np.asarray(self._s_weight, np.float32))
        self._c_qid.append(np.asarray(self._s_qid, np.int64))
        self._s_len = []
        self._s_label = []
        self._s_weight = []
        self._s_qid = []

    def push(self, label: float, indices, values=None, weight: float = 1.0,
             qid: int = -1, fields=None) -> None:
        """Append one row (reference: Push(Row))."""
        idx = np.asarray(indices, dtype=self.index_dtype)
        self._index.append(idx)
        if len(idx):
            self.max_index = max(self.max_index, int(idx.max()))
        if values is not None:
            self._has_value = True
        self._value.append(
            None if values is None else np.asarray(values, np.float32))
        self._s_label.append(float(label))
        if weight != 1.0:
            self._has_weight = True
        self._s_weight.append(float(weight))
        if qid != -1:
            self._has_qid = True
        self._s_qid.append(int(qid))
        if fields is not None:
            self._has_field = True
            self._field.append(np.asarray(fields, np.int64))
        else:
            self._field.append(None)
        self._s_len.append(len(idx))
        self._nrows += 1

    def push_block(self, block: RowBlock, copy: bool = True) -> None:
        """Append a whole RowBlock (reference: Push(RowBlock)).

        Vectorized: whole arrays become chunks (one chunk spans the whole
        block; get_block concatenates chunks, so per-row and per-block
        pushes mix freely). This is the path BasicRowIter/DiskRowIter
        drain through — no per-row Python objects are created.

        ``copy=False`` skips the defensive copy of leased native-arena
        views: the CALLER must then hold the block's lease (via
        ``parser.detach()``) until after ``get_block()``, which
        materializes owned arrays in its single concatenation pass. This
        halves the drain's copy traffic (one copy total, matching the
        reference's C++ Push which also copies exactly once).
        """
        n = block.size
        if n == 0:
            return
        if block.lease is not None and copy:
            # ephemeral native-arena views: the container retains array
            # references, so materialize owned copies first
            block = block.copy()
        self._flush_slabs()
        off = np.asarray(block.offset, np.int64)
        self._c_len.append(off[1:] - off[:-1])
        self._c_label.append(np.asarray(block.label, np.float32))
        # absent weight/qid stay as None placeholders (all-default rows);
        # get_block materializes defaults only if some other chunk made
        # the column real — the common all-default case allocates nothing
        if block.weight is not None:
            w = np.asarray(block.weight, np.float32)
            if bool(np.any(w != 1.0)):
                self._has_weight = True
            self._c_weight.append(w)
        else:
            self._c_weight.append(None)
        if block.qid is not None:
            q = np.asarray(block.qid, np.int64)
            if bool(np.any(q != -1)):
                self._has_qid = True
            self._c_qid.append(q)
        else:
            self._c_qid.append(None)
        idx = np.asarray(block.index, self.index_dtype)
        self._index.append(idx)
        if block.max_index is not None:
            # producer-supplied (native engine computes it during parse)
            self.max_index = max(self.max_index, int(block.max_index))
        elif len(idx):
            self.max_index = max(self.max_index, int(idx.max()))
        if block.value is not None:
            self._has_value = True
            self._value.append(np.asarray(block.value, np.float32))
        else:
            self._value.append(None)
        if block.field is not None:
            self._has_field = True
            self._field.append(np.asarray(block.field, np.int64))
        else:
            self._field.append(None)
        self._nrows += n

    def get_block(self) -> RowBlock:
        """Materialize as an immutable RowBlock (reference: GetBlock)."""
        self._flush_slabs()
        n = self.size
        offset = np.zeros(n + 1, np.int64)
        if self._c_len:
            np.cumsum(np.concatenate(self._c_len), out=offset[1:])
        nnz = int(offset[-1])
        index = (np.concatenate(self._index) if nnz else
                 np.empty(0, self.index_dtype)).astype(self.index_dtype,
                                                       copy=False)
        value = None
        if self._has_value:
            parts = [v if v is not None else np.ones(len(i), np.float32)
                     for v, i in zip(self._value, self._index)]
            value = (np.concatenate(parts) if nnz else
                     np.empty(0, np.float32))
        field = None
        if self._has_field:
            fparts = [f if f is not None else np.zeros(len(i), np.int64)
                      for f, i in zip(self._field, self._index)]
            field = (np.concatenate(fparts) if nnz else np.empty(0, np.int64))
        label = (np.concatenate(self._c_label) if self._c_label
                 else np.empty(0, np.float32))
        weight = qid = None
        if self._has_weight:
            wparts = [w if w is not None else np.ones(len(lb), np.float32)
                      for w, lb in zip(self._c_weight, self._c_label)]
            weight = (np.concatenate(wparts) if wparts
                      else np.empty(0, np.float32))
        if self._has_qid:
            qparts = [q if q is not None else np.full(len(lb), -1, np.int64)
                      for q, lb in zip(self._c_qid, self._c_label)]
            qid = (np.concatenate(qparts) if qparts
                   else np.empty(0, np.int64))
        return RowBlock(
            offset=offset,
            label=label,
            index=index,
            value=value,
            weight=weight,
            qid=qid,
            field=field)

    # -- binary page format (reference: RowBlockContainer::Save/Load)

    @staticmethod
    def save_block(block: RowBlock, stream: Stream) -> None:
        ser.write_u32(stream, _PAGE_MAGIC)
        ser.write_u8(stream, _PAGE_VERSION)
        flags = ((1 if block.value is not None else 0)
                 | (2 if block.weight is not None else 0)
                 | (4 if block.qid is not None else 0)
                 | (8 if block.field is not None else 0))
        ser.write_u8(stream, flags)
        ser.write_ndarray(stream, block.offset)
        ser.write_ndarray(stream, block.label)
        ser.write_ndarray(stream, block.index)
        for present, arr in ((flags & 1, block.value), (flags & 2, block.weight),
                             (flags & 4, block.qid), (flags & 8, block.field)):
            if present:
                ser.write_ndarray(stream, arr)

    @staticmethod
    def load_block(stream: Stream) -> Optional[RowBlock]:
        """Load one page; None at clean EOF. Every array is owned
        (``read_ndarray`` copies): none aliases the stream's buffer."""
        head = stream.read(4)
        if len(head) == 0:
            return None
        check_eq(len(head), 4, "RowBlock page: truncated magic")
        magic = int.from_bytes(head, "little")
        check_eq(magic, _PAGE_MAGIC, "RowBlock page: bad magic")
        version = ser.read_u8(stream)
        check_eq(version, _PAGE_VERSION, "RowBlock page: bad version")
        flags = ser.read_u8(stream)
        offset = ser.read_ndarray(stream)
        label = ser.read_ndarray(stream)
        index = ser.read_ndarray(stream)
        value = ser.read_ndarray(stream) if flags & 1 else None
        weight = ser.read_ndarray(stream) if flags & 2 else None
        qid = ser.read_ndarray(stream) if flags & 4 else None
        field = ser.read_ndarray(stream) if flags & 8 else None
        return RowBlock(offset=offset, label=label, index=index, value=value,
                        weight=weight, qid=qid, field=field)

    def save(self, stream: Stream) -> None:
        self.save_block(self.get_block(), stream)

    def load(self, stream: Stream) -> bool:
        """Replace contents with one page from stream; False at EOF."""
        block = self.load_block(stream)
        if block is None:
            return False
        self.clear()
        self.index_dtype = block.index.dtype
        self.push_block(block)
        return True
