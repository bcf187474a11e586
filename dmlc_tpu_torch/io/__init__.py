"""Streams, the VFS registry, sharded input splits, the streaming split
and the object-store plane: importing this package registers ``obj://``
and its ``s3://`` alias (``dmlc_tpu_torch.io.objstore``)."""

from dmlc_tpu_torch.io.streaming_split import StreamingSplit
from dmlc_tpu_torch.io import objstore  # registers obj:// + s3:// on import

__all__ = ["StreamingSplit", "objstore"]
