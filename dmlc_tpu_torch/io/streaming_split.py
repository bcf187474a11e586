"""EOF-less streaming input over a growing file.

Copy of ``dmlc_tpu/io/streaming_split.py`` with its imports rewritten
to ``dmlc_tpu_torch``; it reads through the port's ``stat_uri`` and
``io.stream.read`` seams.

Every split before this module treats its byte range as FROZEN: the
sizes captured at create are the epoch, EOF is the end, and a mutated
backing file is an error (the shrink detection). A serving-shaped
system ingests the opposite thing — an append-only file (a log, a
feed dump, a producer's staging file) that GROWS while the pipeline
runs. :class:`StreamingSplit` is the InputSplit-shaped reader for that
source:

- **EOF-less**: ``next_chunk()`` polls the source's size (through the
  scheme-aware ``stat_uri`` seam, so ``obj://`` objects stream too)
  and blocks until new whole records exist, instead of returning None
  at the frozen end.
- **Windowed**: appended records accumulate into a *window* closed by
  ``window_records`` (count) and/or ``window_s`` (time since the
  window opened) — one ``next_chunk()`` == one window, feeding the
  unchanged parse/batch/to_device machinery.
- **Watermarked**: the split carries a monotonic watermark — committed
  byte offset, records delivered, windows closed, and the wall time of
  the last advance — surfaced via :meth:`watermark` (pipeline probes stamp
  it into stage extras; the multi-tenant ``/tenants`` rows render it).
- **Mutation-safe**: every read re-opens the source at the COMMITTED
  offset (the last delivered record boundary) through the
  ``io.stream.read`` resilience seam. A short or failed read (an
  injected ``truncate``/``ioerror`` fault, a racing writer) is a clean
  windowed retry — the next poll re-reads from the committed boundary,
  so downstream bytes are never shifted. Only a source that actually
  SHRANK below the committed offset raises (that is a rewrite, not an
  append).

Termination contract (streams do not end, epochs must): ``stop()``
drains what is committed-readable and ends the stream;
``idle_timeout_s`` ends it after that long with no growth (None =
block forever). A consumed split cannot rewind (``rewindable=False``,
the stdin-split precedent) — parsers skip their chunk-prefetch thread
and pull synchronously.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from dmlc_tpu_torch.io.input_split import InputSplit
from dmlc_tpu_torch.io.stream import create_seek_stream_for_read
from dmlc_tpu_torch.obs.metrics import REGISTRY as _METRICS
from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["StreamingSplit"]

_NEWLINE = b"\n\r"


class StreamingSplit(InputSplit):
    """Pull-based EOF-less reader over ONE growing text source.

    A growing file cannot be byte-range sharded (the range is still
    being written), so a StreamingSplit is always one part — gangs
    stream distinct URIs, or fan one stream out downstream.
    """

    rewindable = False  # a stream cannot seek back; parsers skip prefetch

    def __init__(self, uri: str, *,
                 window_records: Optional[int] = None,
                 window_s: Optional[float] = None,
                 poll_interval_s: float = 0.05,
                 idle_timeout_s: Optional[float] = None,
                 chunk_size: int = 8 << 20):
        check(window_records is None or window_records >= 1,
              "StreamingSplit: window_records must be >= 1")
        check(window_s is None or window_s > 0,
              "StreamingSplit: window_s must be > 0")
        check(poll_interval_s > 0,
              "StreamingSplit: poll_interval_s must be > 0")
        self.uri = uri
        self._window_records = window_records
        self._window_s = window_s
        self._poll_s = float(poll_interval_s)
        self._idle_s = idle_timeout_s
        self._chunk_size = max(int(chunk_size), 64 * 1024)
        self._committed = 0          # byte offset of the last delivered
        #                              record boundary (the watermark)
        self._records = 0
        self._windows = 0
        self._bytes_read = 0
        self._retries = 0            # degraded polls (short/failed read)
        self._last_advance = time.time()
        self._consumed = False
        self._stop = threading.Event()
        self._ended = False
        self._record_buf: List[bytes] = []
        self._record_pos = 0
        # the watermark is live telemetry: one registry snapshot sees
        # every stream's progress next to queue/engine stats (weakly
        # registered — a dropped split leaves on its own)
        self._metrics_key = _METRICS.register(
            f"stream/{uri}", self, StreamingSplit.watermark)

    # -- control / telemetry

    def stop(self) -> None:
        """End the stream: the current poll drains whatever whole
        records are already on disk, then ``next_chunk`` returns None."""
        self._stop.set()

    def watermark(self) -> Dict[str, Any]:
        """The monotonic watermark + degradation counters (the shape
        pipeline probes stamp into ``extra["stream"]``; also the
        registered ``stream/<uri>`` metrics collector)."""
        return {
            "uri": self.uri,
            "watermark_bytes": self._committed,
            "watermark_records": self._records,
            "windows": self._windows,
            "retries": self._retries,
            "last_advance_s_ago": round(
                time.time() - self._last_advance, 3),
            "ended": self._ended,
        }

    # -- polling machinery

    def _size(self) -> Optional[int]:
        """Current source size through the scheme-aware stat seam;
        None on a transient stat failure (counted, retried next poll)."""
        from dmlc_tpu_torch.io.pagestore import stat_uri
        try:
            return stat_uri(self.uri)[0]
        except (OSError, DMLCError):
            self._retries += 1
            return None

    def _read_from_committed(self, size: int) -> bytes:
        """One bounded read starting at the committed record boundary.
        Opens fresh each poll (the file is being appended; a held
        stream's EOF state would go stale) and reads through the
        ``io.stream.read`` resilience seam. Short reads — an injected
        truncate fault, a racing writer — return what arrived; the
        next poll re-reads from the same committed boundary, so a
        degraded read can never shift downstream bytes."""
        want = min(size - self._committed, self._chunk_size)
        if want <= 0:
            return b""
        try:
            stream = create_seek_stream_for_read(self.uri)
            try:
                stream.seek(self._committed)
                data = stream.read(want)
            finally:
                stream.close()
        except (OSError, DMLCError):
            self._retries += 1
            return b""
        if len(data) < want:
            # the source answered short of its own stat — a torn poll
            # (fault injection pins the stream at EOF; a writer may be
            # mid-append). Keep the whole records that DID arrive; the
            # rest re-reads next poll from the committed boundary.
            self._retries += 1
        return data

    @staticmethod
    def _last_record_end(buf: bytes) -> int:
        n = max(buf.rfind(b"\n"), buf.rfind(b"\r"))
        return n + 1 if n >= 0 else 0

    @staticmethod
    def _count_records(buf: bytes) -> int:
        return sum(1 for line in buf.splitlines() if line)

    def next_chunk(self) -> Optional[bytes]:
        """One WINDOW of whole appended records, blocking until the
        window closes (count/time), the stream is stopped (drain, then
        None), or ``idle_timeout_s`` passes with no growth (None)."""
        if self._ended:
            return None
        self._consumed = True
        window: List[bytes] = []
        win_records = 0
        win_opened: Optional[float] = None
        idle_since = time.monotonic()
        seen_size = self._committed   # raw growth resets the idle clock
        draining = False              # idle expiry: one stop-style pass
        drain_retries = 0             # faulted polls tolerated at stop
        while True:
            stopping = self._stop.is_set() or draining
            size = self._size()
            grew = False
            if size is not None and size < self._committed:
                raise DMLCError(
                    f"StreamingSplit: source {self.uri!r} shrank to "
                    f"{size} bytes below the committed offset "
                    f"{self._committed} — a streaming source must be "
                    "append-only (rewrites need a fresh split)")
            if size is not None and size > seen_size:
                # RAW byte growth (even mid-record) proves the writer
                # is alive: a slow writer trickling one long line must
                # not be idle-timed out and have its half-line drained
                seen_size = size
                idle_since = time.monotonic()
            if size is not None and size > self._committed:
                data = self._read_from_committed(size)
                cut = self._last_record_end(data)
                if (stopping and cut == 0 and data
                        and len(data) == size - self._committed):
                    # final drain, and the read reached the source's
                    # true end (not a short/faulted or chunk-clipped
                    # read whose record continues on disk): a last
                    # record with no trailing newline is still a whole
                    # record once the writer stopped (the finite-file
                    # epoch would parse it)
                    cut = len(data)
                if cut == 0 and len(data) >= self._chunk_size:
                    # a full buffer without one record boundary: the
                    # record is larger than the poll buffer and no
                    # amount of re-polling can commit it — fail loud
                    # instead of silently re-reading 8 MB per poll
                    # forever (or dropping it at idle timeout)
                    raise DMLCError(
                        f"StreamingSplit: a record at offset "
                        f"{self._committed} of {self.uri!r} exceeds "
                        f"chunk_size={self._chunk_size} bytes; raise "
                        "chunk_size past the longest record")
                if cut > 0:
                    piece = data[:cut]
                    self._committed += cut
                    self._bytes_read += cut
                    n = self._count_records(piece)
                    self._records += n
                    self._last_advance = time.time()
                    idle_since = time.monotonic()
                    grew = True
                    window.append(piece)
                    win_records += n
                    if win_opened is None:
                        win_opened = time.monotonic()
            # window-close rules
            if window:
                full = (self._window_records is not None
                        and win_records >= self._window_records)
                timed = (self._window_s is not None
                         and time.monotonic() - win_opened
                         >= self._window_s)
                unbounded = (self._window_records is None
                             and self._window_s is None)
                if full or timed or stopping or unbounded:
                    self._windows += 1
                    if draining:
                        # idle drain delivers at most one last window
                        self._ended = True
                    return b"".join(window)
            if stopping and not grew:
                if (size is not None and size > self._committed
                        and drain_retries < 50):
                    # readable bytes remain but this poll came back
                    # short/failed (an injected truncate, a transient
                    # error): the stop drain re-polls — ending here
                    # would DROP committed-readable records. Bounded,
                    # so a permanently failing source still ends.
                    drain_retries += 1
                    time.sleep(self._poll_s)
                    continue
                if size is not None and size > self._committed:
                    from dmlc_tpu_torch.obs.log import warn_limited
                    warn_limited(
                        "streaming-drain-gave-up",
                        f"StreamingSplit: stop drain of {self.uri!r} "
                        f"gave up with {size - self._committed} "
                        "unreadable bytes after 50 failed polls",
                        min_interval_s=10.0)
                # stopped and drained: stream over
                self._ended = True
                return b"".join(window) if window else None
            if (self._idle_s is not None and not grew and not draining
                    and time.monotonic() - idle_since >= self._idle_s):
                # the writer went quiet: take ONE stop-style drain
                # pass (an unterminated final line commits exactly
                # like stop() — the finite-file epoch would parse it),
                # then end
                draining = True
                continue
            time.sleep(self._poll_s)

    # -- InputSplit surface

    def next_record(self) -> Optional[bytes]:
        while self._record_pos >= len(self._record_buf):
            chunk = self.next_chunk()
            if chunk is None:
                return None
            self._record_buf = list(self.extract_records(chunk))
            self._record_pos = 0
        rec = self._record_buf[self._record_pos]
        self._record_pos += 1
        return rec

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        for line in chunk.splitlines():
            if line:
                yield line

    def before_first(self) -> None:
        if not self._consumed:
            return  # fresh stream: nothing to rewind
        raise DMLCError(
            "StreamingSplit cannot rewind: a stream has no beginning "
            "to return to (create a fresh split for a new run)")

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        check(num_parts == 1,
              "StreamingSplit has exactly one part (a growing file "
              "cannot be byte-range sharded)")

    def get_total_size(self) -> int:
        return self._committed

    @property
    def bytes_read(self) -> int:
        return self._bytes_read
