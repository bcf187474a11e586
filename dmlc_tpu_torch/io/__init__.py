"""Streams, the VFS registry, sharded input splits, RecordIO, the page
store, the streaming split and the object-store plane: importing this
package registers ``cuda://`` (``io.cuda_fs``, the counterpart of the
reference's ``tpu://``), ``obj://`` and its ``s3://`` alias
(``dmlc_tpu_torch.io.objstore``)."""

from dmlc_tpu_torch.io.stream import (
    Stream, SeekStream, MemoryStream, Serializable, create_stream,
    create_seek_stream_for_read,
)
from dmlc_tpu_torch.io.filesys import FileSystem, FileInfo, URI, LocalFileSystem
from dmlc_tpu_torch.io.tempdir import TemporaryDirectory
from dmlc_tpu_torch.io.input_split import InputSplit
from dmlc_tpu_torch.io.recordio import (
    RecordIOWriter, RecordIOReader, RecordIOChunkReader, RECORDIO_MAGIC,
)
from dmlc_tpu_torch.io.cuda_fs import (  # registers cuda:// on import
    CUDAFileSystem, CUDASeekStream, recordio_device_batches,
)
from dmlc_tpu_torch.io.pagestore import PageStore
from dmlc_tpu_torch.io.streaming_split import StreamingSplit
from dmlc_tpu_torch.io import objstore  # registers obj:// + s3:// on import

__all__ = [
    "Stream", "SeekStream", "MemoryStream", "Serializable", "create_stream",
    "create_seek_stream_for_read", "FileSystem", "FileInfo", "URI",
    "LocalFileSystem", "TemporaryDirectory", "InputSplit",
    "RecordIOWriter", "RecordIOReader", "RecordIOChunkReader",
    "RECORDIO_MAGIC", "CUDAFileSystem", "CUDASeekStream",
    "recordio_device_batches", "PageStore", "StreamingSplit", "objstore",
]
