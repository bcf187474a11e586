"""The port's page codec (``dmlc_tpu_torch/io/codec.py``) against the JAX
package's (``dmlc_tpu/io/codec.py``): frames byte-identical at every
level for the same input, each package decoding the other's frames, and
every corrupt frame of ``tests/test_codec.py`` refused with the port's
DMLCError. Inputs are made from seeds with numpy."""

import numpy as np
import pytest

from dmlc_tpu.io import codec as ref_codec
from dmlc_tpu_torch.io import codec
from dmlc_tpu_torch.utils.logging import DMLCError

LEVELS = [0, 1, 6, 9]


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "empty": b"",
        "compressible": b"ab" * 50000,
        "random": rng.bytes(20000),
        "magic_prefixed": b"DTPC" + b"payload" * 64,
        "libsvm_text": b"0 1:0.5 2:0.25\n" * 10000,
        "already_encoded": ref_codec.encode_page(b"x" * 4096, 6),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("level", LEVELS)
def test_encode_page_matches_reference(level, name):
    data = INPUTS[name]
    enc = codec.encode_page(data, level)
    assert enc == ref_codec.encode_page(data, level)
    assert codec.decode_page(enc) == data
    assert len(enc) <= len(data) + codec.HEADER_BYTES


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("level", LEVELS)
def test_frames_cross_decode(level, name):
    data = INPUTS[name]
    assert codec.decode_page(ref_codec.encode_page(data, level)) == data
    assert ref_codec.decode_page(codec.encode_page(data, level)) == data


def _corrupt_frames():
    enc = ref_codec.encode_page(b"payload" * 1000, 6)
    flipped = bytearray(enc)
    flipped[ref_codec.HEADER_BYTES + 5] ^= 0xFF
    bad_ver = bytearray(enc)
    bad_ver[4] = 99
    bad_codec = bytearray(enc)
    bad_codec[5] = 7
    stored = bytearray(ref_codec.encode_page(b"DTPC" + b"\x11" * 100, 0))
    stored[-1] ^= 0x01
    return {
        "flipped_payload": (bytes(flipped), "corrupt compressed page"),
        "truncated_payload": (enc[:ref_codec.HEADER_BYTES + 3],
                              "corrupt compressed page"),
        "truncated_header": (enc[:10], "truncated page header"),
        "bad_version": (bytes(bad_ver), "version"),
        "bad_codec_id": (bytes(bad_codec), "codec id"),
        "stored_crc": (bytes(stored), "crc mismatch"),
    }


CORRUPT = _corrupt_frames()


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_corrupt_frames_raise(case):
    frame, match = CORRUPT[case]
    with pytest.raises(DMLCError, match=match):
        codec.decode_page(frame)


def test_constants_and_tags_match_reference():
    assert codec.PAGE_CODEC_MAGIC == ref_codec.PAGE_CODEC_MAGIC
    assert codec.HEADER_BYTES == ref_codec.HEADER_BYTES == 20
    assert codec.ENV_LEVEL == ref_codec.ENV_LEVEL
    for level in LEVELS:
        assert codec.tag(level) == ref_codec.tag(level)
    assert codec.is_encoded(codec.encode_page(b"DTPC", 0))
    assert not codec.is_encoded(b"raw bytes")


@pytest.mark.parametrize("env,want", [(None, 0), ("6", 6), ("40", 9),
                                      ("junk", 0)])
def test_env_default_level_matches_reference(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv(codec.ENV_LEVEL, raising=False)
    else:
        monkeypatch.setenv(codec.ENV_LEVEL, env)
    assert codec.default_level() == ref_codec.default_level() == want
