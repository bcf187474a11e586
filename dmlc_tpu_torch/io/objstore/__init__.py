"""Remote object-store I/O plane: ``obj://`` URIs hydrating the
unified page store.

Counterpart of ``dmlc_tpu/io/objstore``: upstream dmlc-core ships
S3/HDFS/Azure backends behind one ``FileSystem`` interface, and this
package is that plane for the port.
:class:`~dmlc_tpu_torch.io.objstore.fs.ObjectStoreFileSystem` is
registered for ``obj://`` (with an ``s3://`` alias) in the scheme
registry when ``dmlc_tpu_torch.io`` is imported, and reads through
ranged parallel GETs with request coalescing, hydrating fetched blocks
into :mod:`dmlc_tpu_torch.io.pagestore` — so a second epoch over the
same remote URI never touches the wire. The backend is a pluggable
client protocol: the on-disk
:class:`~dmlc_tpu_torch.io.objstore.emulator.EmulatedObjectStore`
(tests, benches), or the stdlib HTTP client over a real endpoint.

    from dmlc_tpu_torch.io import objstore
    em = objstore.configure(root="/tmp/objstore")   # emulator backend
    em.put("bucket", "train/data.libsvm", payload)
    Pipeline.from_uri("obj://bucket/train/data.libsvm").parse(
        format="libsvm")...

Trimmed from the reference: the gang peer tier (``peer``), which waits
for the status server plane (``obs/serve.py``).
"""

from dmlc_tpu_torch.io.filesys import FileSystem
from dmlc_tpu_torch.io.objstore.emulator import EmulatedObjectStore, ObjectInfo
from dmlc_tpu_torch.io.objstore.fs import (
    ENV_AUTH, ENV_ENDPOINT, ENV_GBPS, ENV_LATENCY, ENV_ROOT,
    ObjectSeekStream, ObjectStoreFileSystem, client, configure, options,
)

# NOTE: http_client (the real networked ranged-GET client) is
# import-optional by design — configure(endpoint=...) loads it lazily;
# importing this package must not pull the wire stack in.

__all__ = [
    "ObjectStoreFileSystem", "ObjectSeekStream", "EmulatedObjectStore",
    "ObjectInfo", "configure", "client", "options",
    "ENV_ROOT", "ENV_LATENCY", "ENV_GBPS", "ENV_ENDPOINT", "ENV_AUTH",
]

# register the schemes: obj:// is the canonical name, s3:// aliases to
# the same plane
FileSystem.register_scheme("obj://",
                           lambda: ObjectStoreFileSystem("obj://"))
FileSystem.register_scheme("s3://",
                           lambda: ObjectStoreFileSystem("s3://"))
