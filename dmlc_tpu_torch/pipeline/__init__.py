"""dmlc_tpu_torch.pipeline — declarative dataset-pipeline graphs.

Counterpart of ``dmlc_tpu.pipeline``: a tf.data-style chain
(``Pipeline.from_uri(...).parse(...).batch(...).to_device()``) that
compiles down to the port's Parser / ThreadedIter / padded batch
assembly / pinned async H2D, with a telemetry probe at every stage
boundary (``dmlc_tpu_torch.pipeline.stats``) and a between-epoch
autotuner over queue depths and the copy window
(``dmlc_tpu_torch.pipeline.autotune``). The reference's multi-tenant
scheduler is not ported.
"""

from dmlc_tpu_torch.pipeline.autotune import Autotuner, Knob
from dmlc_tpu_torch.pipeline.graph import CompiledPipeline, Pipeline
from dmlc_tpu_torch.pipeline.stages import StageSpec
from dmlc_tpu_torch.pipeline.stats import (
    PIPELINE_STATS_SCHEMA, StageProbe, snapshot,
)

__all__ = [
    "Pipeline", "CompiledPipeline", "StageSpec",
    "Autotuner", "Knob",
    "StageProbe", "snapshot", "PIPELINE_STATS_SCHEMA",
]
