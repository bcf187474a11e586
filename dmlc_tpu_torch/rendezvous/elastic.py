"""Elastic ownership: the pure rule mapping content to a gang rank.

Copy of the part of ``dmlc_tpu/rendezvous/elastic.py`` that the port's
remote checkpoints use: :func:`content_owner` and the modular
:func:`owner_of` under it, pure and stdlib-only, so both packages send
a page to the same rank. Trimmed from the reference: ``assign_parts``,
``resume_skip`` and ``reshard_plan`` (the elastic resharding plan) and
``gang_metadata`` (the membership stamp of a checkpoint's
``meta.json``), which wait for the rendezvous plane.
"""

from __future__ import annotations

from dmlc_tpu_torch.utils.logging import check

__all__ = ["owner_of", "content_owner"]


def owner_of(part: int, world: int) -> int:
    """The rank owning ``part`` in a ``world``-member gang: the strided
    partition ``part % world``."""
    check(world >= 1, "owner_of needs world >= 1")
    return part % world


def content_owner(digest: str, world: int) -> int:
    """The rank owning a content-addressed page in a ``world``-member
    gang: the digest's leading 48 bits mod world. This is the restore
    fanout's re-cut — pages were written by the SAVING world (any N),
    and every RESTORING member (any M) independently maps each digest
    to the same owner, who wire-fetches it while everyone else takes
    it from the owner's ``/pages`` tier. Pure, uniform (digests are
    cryptographic, so leading bits are), and world-size agnostic — the
    different-world restore needs no negotiation, just this function
    at the new M."""
    check(bool(digest), "content_owner needs a digest")
    return owner_of(int(digest[:12], 16), world)
