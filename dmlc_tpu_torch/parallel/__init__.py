"""The host→device edge (pinned staging and async prefetch) and the
data-parallel gang: ``launch`` (``torch.distributed`` rendezvous and
local workers) and ``sharded`` (the part mesh, sharded ingest)."""
