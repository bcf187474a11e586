"""dmlc_tpu_torch: the PyTorch/CUDA port of dmlc_tpu.

The module layout mirrors ``dmlc_tpu``: each module here has its
counterpart at the same path there, and the JAX package stays the
reference the tests hold this one to. This package imports torch and
numpy, never jax, and nothing of ``dmlc_tpu``.

Ported so far: local-file ``InputSplit`` (text and RecordIO; stdin,
``#cache`` URIs, the shuffled and threaded splits, and the indexed
RecordIO split with its seeded batch shuffle and native reader), the
libsvm, csv, libfm, dense-record, image-record and Parquet parsers
(Python golden and native C++ engine, with ABI-5 padded batch assembly
that carries libfm's ``field`` column, and the sharded single-input
parse; the Parquet golden needs pyarrow, the engine's page decoder
does not), the RecordIO codec and native record reader, the ``cuda://``
scheme (streams that
stage bytes and RecordIO record batches straight into device memory),
bucket padding, the pinned async
host→device iterator, the pipeline graph (``dmlc_tpu_torch.pipeline``:
``Pipeline.from_uri(...).parse(...).batch(...).to_device(...).build()``
with its stage probes and autotuner), the CSR SpMV kernels with their
weight-gradient transpose, the padded-row dot and the CSR-to-dense
scatter, the FM and FFM pair-term kernels with their gradients in V,
the pairwise ranking loss with its gradient in the margins, and SGD for
``SparseLinearModel``, ``SparseFMModel``, ``SparseFFMModel`` and
``SparseRankingModel`` (over libsvm ``qid``), on one device and data
parallel over a ``torch.distributed`` group (``parallel.launch``,
``parallel.sharded``, ``Pipeline.shard``, ``graft``), the trace plane
(``dmlc_tpu_torch.obs``: spans, Chrome export, metrics, ``cuda_trace``,
the stall watchdog and the flight recorder, and the RPC trace-context
plane), the resilience plane (``dmlc_tpu_torch.resilience``: retry
policies at the host I/O seams, seeded fault injection, gang
supervision with restarts), and the object-store plane
(``dmlc_tpu_torch.io.objstore``: ``obj://`` and ``s3://`` reads that
hydrate the page store, the multipart writer, the HTTP client, and
remote ``ShardedCheckpoint`` roots), and the gang plane: the live
status server (``dmlc_tpu_torch.obs.serve``), the objstore peer tier
that reads a gang's blocks and checkpoint pages from the rank that
owns them, and rendezvous membership (``dmlc_tpu_torch.rendezvous``:
the service, its client and the elastic ownership rules).
Entry points that touch a device default to ``torch.device("cuda")``;
pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""

from dmlc_tpu_torch.utils.logging import DMLCError
from dmlc_tpu_torch.data.parser import Parser
from dmlc_tpu_torch.data import libsvm_parser as _libsvm  # registers "libsvm"
from dmlc_tpu_torch.data import csv_parser as _csv  # registers "csv"
from dmlc_tpu_torch.data import libfm_parser as _libfm  # registers "libfm"
from dmlc_tpu_torch.data import dense_record_parser as _dense  # "recordio_dense"
from dmlc_tpu_torch.data import image_record_parser as _image  # "recordio_image"
from dmlc_tpu_torch.data import parquet_parser as _parquet  # "parquet", "parquet_native"
from dmlc_tpu_torch.io import cuda_fs as _cuda_fs  # registers cuda://
# (importing dmlc_tpu_torch.io registers obj:// and s3://)

__all__ = ["DMLCError", "Parser"]

del _libsvm, _csv, _libfm, _dense, _image, _parquet, _cuda_fs
