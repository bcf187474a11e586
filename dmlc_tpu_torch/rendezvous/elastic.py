"""Elastic resharding: deterministic N→M shard re-agreement.

Copy of ``dmlc_tpu/rendezvous/elastic.py`` with its imports rewritten
to ``dmlc_tpu_torch``; pure and stdlib-only, so both packages derive
the same ownership, resume offsets and plans.

The recovery story is determinism — a shard stream is a pure function
of ``(uri, part, num_parts, seed, epoch)`` — but without this module
the WORLD is fixed: a dead member could only ever be replaced at identical
coordinates. Here the same contract goes elastic. Ownership of the
``num_parts`` input parts is itself a pure function of ``(num_parts,
world, rank)`` (:func:`assign_parts`), so when the rendezvous service
bumps the membership epoch from N to M members, every survivor
independently computes the SAME new partition — no negotiation, no
state migration, just new inputs to the same function.

Mid-epoch resume (:func:`reshard_plan`): the service's merged
progress map says, per part, how many records the previous owner had
already consumed. Because a killed consumer's progress is a PREFIX of
the deterministic stream, the new owner resumes by skipping exactly
that prefix — the skipped
records' bytes are already committed to the unified page store (and
peer-servable), so the resume costs page reads, not wire bytes, and
global coverage stays exactly-once: every record consumed by exactly
one member across the membership change.

Checkpoint integration: :func:`gang_metadata` is the membership stamp
``ShardedCheckpoint.save`` writes into ``meta.json`` — a restore
after a world change knows which (gang, epoch, world, rank) produced
each shard and re-derives ownership the same way.

Everything here is pure and stdlib-only; the I/O lives in
:mod:`dmlc_tpu_torch.rendezvous.service` and the consumers.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

from dmlc_tpu_torch.utils.logging import check

__all__ = ["assign_parts", "owner_of", "reshard_plan", "resume_skip",
           "content_owner", "gang_metadata"]


def assign_parts(num_parts: int, world: int, rank: int) -> List[int]:
    """The parts rank ``rank`` owns in a ``world``-member gang: the
    strided partition ``{p : p % world == rank}`` — the same modular
    contract the peer tier uses for page-group ownership, so data
    locality survives reshards for the parts a member keeps."""
    check(num_parts >= 1, "assign_parts needs num_parts >= 1")
    check(world >= 1, "assign_parts needs world >= 1")
    check(0 <= rank < world,
          f"rank {rank} outside world {world}")
    return [p for p in range(num_parts) if p % world == rank]


def owner_of(part: int, world: int) -> int:
    """The rank owning ``part`` — the inverse view of
    :func:`assign_parts` (pure, shared by tests and the planner)."""
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


def resume_skip(progress: Optional[Mapping[Any, Any]],
                part: int) -> int:
    """Records of ``part`` already consumed gang-wide (0 when the
    part was never started). The service keys its progress map by
    stringified part (JSON object keys); accept both."""
    if not progress:
        return 0
    v = progress.get(str(part), progress.get(part, 0))
    return max(0, int(v)) if isinstance(v, (int, float)) else 0


def reshard_plan(num_parts: int, world: int,
                 progress: Optional[Mapping[Any, Any]] = None,
                 ) -> Dict[int, List[Tuple[int, int]]]:
    """The full post-reshard work plan: rank -> ``[(part,
    skip_records), ...]`` for the NEW world. ``skip_records`` is the
    committed prefix the part's (possibly previous) owner already
    consumed — the new owner fast-forwards past it over the page
    store instead of re-emitting records a dead member already
    counted. Every part appears exactly once across all ranks —
    exactly-once coverage is the plan's invariant, asserted here
    rather than trusted."""
    plan = {rank: [(p, resume_skip(progress, p))
                   for p in assign_parts(num_parts, world, rank)]
            for rank in range(world)}
    covered = sorted(p for parts in plan.values() for p, _ in parts)
    check(covered == list(range(num_parts)),
          f"reshard plan lost coverage: {covered} != "
          f"0..{num_parts - 1}")
    return plan


def gang_metadata(client: Any = None) -> Optional[Dict[str, Any]]:
    """The membership stamp for checkpoint metadata: ``{"gang",
    "member", "rank", "epoch", "world"}`` from the active (or given)
    rendezvous client; None outside a rendezvous gang — callers store
    it only when it exists."""
    if client is None:
        from dmlc_tpu_torch import rendezvous as _rndv
        client = _rndv.active()
    if client is None or client.rank is None:
        return None
    return {"gang": client.gang, "member": client.member,
            "rank": client.rank, "epoch": client.epoch,
            "world": client.world}
