"""The index rule of every plain version, in one place (its CUDA twin:
``csrc/index.cuh``).

The reference reads an index the way JAX does without x64: a u64 index
is cut to its low 32 bits when it becomes a device array, every gather
casts it with ``astype(int32)``, and ``jnp.take`` / ``.at[]`` count a
negative index from the end. So a raw index (u32, u64 or int32) maps to
its low 32 bits as a signed int32 ``j``, then ``j + n`` where ``j < 0``,
and is valid where ``0 <= j < n``: u32 2³²−1 reads the last entry, u32
2³¹ is invalid, u64 2³²+3 reads entry 3. A forward reads NaN for an
invalid index and a backward or a scatter drops it. A field id (FFM)
takes the same low 32 bits, signed, before ``jnp.clip`` into the fields.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["wrap_index", "clip_field"]


def _low32_signed(t: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an integer tensor as signed int32 values, in
    int64."""
    low = t.to(torch.int64) & 0xFFFFFFFF
    return torch.where(low >= 2 ** 31, low - 2 ** 32, low)


def wrap_index(index: torch.Tensor, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the entry of a table of ``n`` each index reads, as int64 with 0
    where it is invalid; whether it is valid)."""
    j = _low32_signed(index)
    j = torch.where(j < 0, j + n, j)
    valid = (j >= 0) & (j < n)
    return torch.where(valid, j, 0), valid


def clip_field(field: torch.Tensor, num_fields: int) -> torch.Tensor:
    """The field (int64, in [0, num_fields)) each raw field id selects."""
    return _low32_signed(field).clamp(0, num_fields - 1)
