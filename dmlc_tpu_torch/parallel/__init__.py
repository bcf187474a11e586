"""The host→device edge (pinned staging and async prefetch) and the
data-parallel gang: ``launch`` (``torch.distributed`` rendezvous, local
workers with the parameter-server role set, ssh command lines and the
submit CLI), ``backends`` (mpi, slurm, sge and kubernetes submit
generators), ``sharded`` (the part mesh, sharded ingest) and
``placement`` (``NamedSharding`` over the part mesh, ``PlacedTensor``,
``device_put``: which slice of an array each part holds)."""
