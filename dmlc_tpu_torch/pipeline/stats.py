"""Per-stage telemetry for compiled pipelines.

Counterpart of ``dmlc_tpu/pipeline/stats.py``. Every stage boundary in a
compiled :class:`~dmlc_tpu_torch.pipeline.Pipeline` carries a
:class:`StageProbe`. The probe sits at the pull site: each time the
downstream consumer asks the stage for an item it records

- **wait time** — seconds the consumer blocked waiting for the stage to
  deliver (the stage's un-overlapped latency),
- **items / rows / bytes** — volume counters for throughput,
- **queue occupancy** — for queue-backed stages (``prefetch``, the
  parser's chunk prefetch), a per-pull sample of ``qsize/capacity`` so
  the autotuner can tell producer-bound (queue empty) from
  consumer-bound (queue full) stages.

``snapshot()`` freezes one epoch of probes into a plain-JSON dict with a
versioned schema (``PIPELINE_STATS_SCHEMA``), the reference's shape.

Items are RowBlocks, dicts of numpy arrays (padded batches), or dicts of
torch tensors (what ``to_device`` yields). A dict that carries host-side
``counts`` (rows, nnz) is counted by them: ``to_device`` reads them from
the host batch before its copy, so the probe never reads a device tensor
(which would wait for the card).

Stage-specific ``extra`` fields (additive, schema version unchanged):

- parse: ``bytes_read``, ``engine`` (native engine stats)
- assemble: ``assembly_path`` ("native-padded" | "python-fused"),
  ``assemble_s``
- prefetch: ``producer`` (the queue's producer counters)
- to_device: ``xfer_wait_s`` (copy-drain wait), ``staging_assemble_s``
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["StageProbe", "snapshot", "PIPELINE_STATS_SCHEMA"]

# bump when snapshot()'s shape changes incompatibly
PIPELINE_STATS_SCHEMA = 1


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    nb = getattr(v, "nbytes", None)
    return int(nb) if nb is not None else 0


def _item_stats(item) -> tuple:
    """(rows, nnz, bytes) of one pipeline item: RowBlock, dict of arrays
    or tensors, or opaque (counted as zeros — items is always exact)."""
    # RowBlock duck-type: .offset/.size/.memory_cost_bytes
    cost = getattr(item, "memory_cost_bytes", None)
    if cost is not None:
        return int(item.size), int(item.nnz), int(cost())
    if isinstance(item, dict):
        nbytes = sum(_nbytes(v) for v in item.values())
        counts = getattr(item, "counts", None)
        if counts is not None:
            return int(counts[0]), int(counts[1]), nbytes
        rows = nnz = 0
        nr = item.get("num_rows")
        if nr is not None:
            rows = int(np.sum(np.asarray(nr)))
        elif "label" in item and hasattr(item["label"], "shape"):
            shape = tuple(item["label"].shape)
            rows = int(np.prod(shape)) if shape else 0
        nz = item.get("num_nnz")
        if nz is not None:
            nnz = int(np.sum(np.asarray(nz)))
        elif "index" in item and hasattr(item["index"], "shape"):
            nnz = int(np.prod(tuple(item["index"].shape)))
        return rows, nnz, nbytes
    return 0, 0, 0


class StageProbe:
    """Accumulates one epoch of boundary measurements for one stage."""

    __slots__ = ("name", "kind", "items", "rows", "nnz", "bytes",
                 "wait_s", "occupancy_sum", "occupancy_samples",
                 "queue_cap", "extra")

    def __init__(self, name: str, kind: str):
        self.name = name
        self.kind = kind
        self.extra: Dict[str, Any] = {}
        self.reset()

    def reset(self) -> None:
        self.items = 0
        self.rows = 0
        self.nnz = 0
        self.bytes = 0
        self.wait_s = 0.0
        self.occupancy_sum = 0
        self.occupancy_samples = 0
        self.queue_cap: Optional[int] = None
        self.extra = {}

    def record(self, item, wait_s: float, queue=None) -> None:
        """One delivered item: wait seconds + volume + queue sample."""
        self.wait_s += wait_s
        self.items += 1
        rows, nnz, nbytes = _item_stats(item)
        self.rows += rows
        self.nnz += nnz
        self.bytes += nbytes
        if queue is not None:
            self.occupancy_sum += queue.qsize()
            self.occupancy_samples += 1
            self.queue_cap = queue.capacity

    def record_wait_only(self, wait_s: float) -> None:
        """Terminal wait (the pull that returned end-of-stream)."""
        self.wait_s += wait_s

    def as_dict(self, wall_s: float) -> Dict[str, Any]:
        occ = (self.occupancy_sum / self.occupancy_samples
               if self.occupancy_samples else None)
        out: Dict[str, Any] = {
            "name": self.name,
            "kind": self.kind,
            "items": self.items,
            "rows": self.rows,
            "nnz": self.nnz,
            "bytes": self.bytes,
            "wait_s": round(self.wait_s, 6),
            "wait_frac": (round(self.wait_s / wall_s, 4)
                          if wall_s > 0 else None),
            "throughput_gbps": (round(self.bytes / wall_s / 1e9, 4)
                                if wall_s > 0 else None),
            "rows_per_s": (round(self.rows / wall_s, 1)
                           if wall_s > 0 else None),
            "queue_depth_mean": (round(occ, 2) if occ is not None
                                 else None),
            "queue_cap": self.queue_cap,
            "queue_occupancy": (round(occ / self.queue_cap, 3)
                                if occ is not None and self.queue_cap
                                else None),
        }
        if self.extra:
            # stage-specific fields (device xfer wait, engine stats, ...)
            out["extra"] = dict(self.extra)
        return out


def snapshot(probes: List[StageProbe], wall_s: float, epoch: int,
             knobs: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """Freeze one epoch of probes into the versioned stats dict."""
    return {
        "schema": PIPELINE_STATS_SCHEMA,
        "epoch": epoch,
        "wall_s": round(wall_s, 4),
        "stages": [p.as_dict(wall_s) for p in probes],
        "knobs": dict(knobs or {}),
    }
