"""Image-record RecordIO parser — the Python golden of the engine's
ABI-8 ``recordio_image`` decode lane.

Copy of ``dmlc_tpu/data/image_record_parser.py`` with its imports
rewritten to ``dmlc_tpu_torch``. The format is the frozen image payload encoding of
``io/recordio.py`` (``u32 h | u32 w | u32 c | f32 label |
u8[h*w*c]`` HWC pixels, little-endian) inside standard RecordIO
framing — the MXNet-style ImageNet ``.rec`` scenario (BASELINE config
3), raw/uniform-shape first (JPEG payloads stay an undecoded record
stream through the plain RecordIO reader). Each record becomes one CSR
row whose indices are the pixel ordinals ``0..h*w*c-1`` and whose
values are the pixels widened u8 -> f32 (``(float)u8`` is exact), so
the native decoder (engine.cc ``ParseRecIOImageSlice``) is
byte-identical by construction — pinned by tests/test_torch_recordio.py,
incl. escaped-magic pixel runs and sharded parses.

``pipeline.from_uri("x.rec").parse(format="recordio_image")
.batch(rows, pad=True, nnz_bucket=rows*h*w*c)`` lowers onto the
engine's ABI-5/6 ``NextPadded`` lease path when the native engine is
built (decoded fixed-shape device batches: ``value`` reshapes to
``[rows, h, w, c]``), and onto this golden otherwise.
"""

from __future__ import annotations

from typing import List

import numpy as np

from dmlc_tpu_torch.data.parser import PARSER_REGISTRY, TextParserBase
from dmlc_tpu_torch.data.rowblock import RowBlockContainer
from dmlc_tpu_torch.io.recordio import decode_image_record
from dmlc_tpu_torch.utils.logging import check

__all__ = ["ImageRecordParser"]


class ImageRecordParser(TextParserBase):
    """Chunked image-record parser over the RecordIO InputSplit (the
    split realigns shard boundaries by magic scan and stitches
    multi-frame records — identical boundary contract to the engine's
    RecordIOShardReader)."""

    def __init__(self, **kwargs):
        split_type = kwargs.pop("split_type", "recordio")
        check(split_type == "recordio",
              f"recordio_image: split_type must be 'recordio', "
              f"got {split_type!r}")
        kwargs.pop("format", None)
        super().__init__(split_type="recordio", **kwargs)

    def parse_block(self, records: List[bytes],
                    container: RowBlockContainer) -> None:
        dt = self.index_dtype
        for payload in records:
            label, pixels = decode_image_record(payload)
            flat = pixels.reshape(-1).astype(np.float32)
            container.push(label, np.arange(flat.size, dtype=dt), flat)


@PARSER_REGISTRY.register(
    "recordio_image",
    description="RecordIO-framed raw HWC u8 image records "
                "(u32 h | u32 w | u32 c | f32 label | u8[h*w*c])")
def _make_recordio_image(**kwargs):
    from dmlc_tpu_torch.data.parser import native_or
    return native_or("NativeImageRecordParser", ImageRecordParser, kwargs)
