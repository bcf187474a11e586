"""Parse parity of the port's host plane with the JAX package's.

The port keeps its own copies of the input split, the libsvm parser, the
native engine and the padding layer. Its CSR must stay byte-identical to
the reference's (``RowBlock.content_hash()``), for the Python and the
native engine, whole and sharded; its padded batches (native
``next_padded`` and Python ``pad_single``) byte-identical dicts.
"""

import re

import numpy as np
import pytest
import torch

from dmlc_tpu.data.padding import pad_single as ref_pad_single
from dmlc_tpu.data.parser import Parser as RefParser
from dmlc_tpu.data.rowblock import RowBlockContainer as RefContainer
from dmlc_tpu_torch.data.padding import pad_single, pad_to_bucket
from dmlc_tpu_torch.data.parser import Parser
from dmlc_tpu_torch.data.rowblock import RowBlockContainer
from dmlc_tpu_torch.io.input_split import InputSplit
from dmlc_tpu_torch.native import native_available
from dmlc_tpu_torch.native.bindings import NativeLibSVMParser
from dmlc_tpu_torch.utils.logging import DMLCError


def _lines(rows=1500, seed=0, qid=False, one_based=False, max_nnz=9):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(rows):
        nnz = rng.randint(0, max_nnz + 1)
        idx = np.sort(rng.choice(3000, nnz, replace=False)) + int(one_based)
        feats = " ".join(f"{j}:{v:.6f}" for j, v in zip(idx, rng.rand(nnz)))
        q = f"qid:{i // 40} " if qid else ""
        out.append(f"{(-1) ** i} {q}{feats}".rstrip())
    return out


CORPORA = {
    "plain": lambda: "\n".join(_lines()) + "\n",
    "crlf": lambda: "\r\n".join(_lines(seed=1)) + "\r\n",
    "empty_lines": lambda: "\n\n".join(_lines(seed=2)) + "\n\n\n",
    "no_trailing_newline": lambda: "\n".join(_lines(seed=3)),
    "qid": lambda: "\n".join(_lines(seed=4, qid=True)) + "\n",
}


@pytest.fixture(scope="module")
def native():
    if not native_available():
        pytest.fail("the port's native engine did not build")
    return True


def _hash(parser, container_cls):
    c = container_cls(np.uint32)
    for block in parser:
        c.push_block(block)
    return c.get_block().content_hash()


def _ref_hash(path, part=0, parts=1, **kw):
    return _hash(RefParser.create(path, part, parts, format="libsvm",
                                  engine="python", **kw), RefContainer)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("engine", ["python", "native"])
def test_whole_file_content_hash(tmp_path, corpus, engine, native):
    path = tmp_path / "a.libsvm"
    path.write_text(CORPORA[corpus]())
    p = Parser.create(str(path), format="libsvm", engine=engine)
    if engine == "native":
        assert isinstance(p, NativeLibSVMParser)
    assert _hash(p, RowBlockContainer) == _ref_hash(str(path))


@pytest.mark.parametrize("engine", ["python", "native"])
def test_four_way_sharded_content_hash(tmp_path, engine, native):
    """Each of 4 byte-range parts matches the reference's part, and the
    parts concatenate to the whole file (chunk size small enough that
    every part spans several chunks)."""
    path = tmp_path / "a.libsvm"
    path.write_text("\r\n".join(_lines(rows=3000, seed=5)) + "\r\n")
    whole = RowBlockContainer(np.uint32)
    for part in range(4):
        p = Parser.create(str(path), part, 4, format="libsvm",
                          engine=engine, chunk_size=64 << 10)
        c = RowBlockContainer(np.uint32)
        for block in p:
            c.push_block(block)
            whole.push_block(block)
        assert c.get_block().content_hash() == _ref_hash(str(path), part, 4)
    assert whole.get_block().content_hash() == _ref_hash(str(path))


@pytest.mark.parametrize("mode", [1, -1])
@pytest.mark.parametrize("engine", ["python", "native"])
def test_indexing_mode(tmp_path, mode, engine, native):
    path = tmp_path / "one.libsvm"
    path.write_text("\n".join(_lines(seed=6, one_based=True)) + "\n")
    p = Parser.create(str(path), format="libsvm", engine=engine,
                      indexing_mode=mode)
    assert (_hash(p, RowBlockContainer)
            == _ref_hash(str(path), indexing_mode=mode))


def test_indexing_mode_one_rejects_zero(tmp_path):
    path = tmp_path / "z.libsvm"
    path.write_text("1 0:1.0 3:2.0\n")
    with pytest.raises(DMLCError):
        list(Parser.create(str(path), format="libsvm", engine="python",
                           indexing_mode=1))


def _ref_padded(path, rows, nnz_bucket):
    c = RefContainer(np.uint32)
    for block in RefParser.create(path, format="libsvm", engine="python"):
        c.push_block(block)
    block = c.get_block()
    return [ref_pad_single(block.slice(s, min(s + rows, block.size)),
                           rows, nnz_bucket)
            for s in range(0, block.size, rows)]


def _assert_same_dict(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("corpus", ["plain", "qid", "no_trailing_newline"])
def test_native_next_padded_matches_reference(tmp_path, corpus, native):
    path = tmp_path / "a.libsvm"
    path.write_text(CORPORA[corpus]())
    rows, nb = 256, 256 * 9
    want = _ref_padded(str(path), rows, nb)
    p = Parser.create(str(path), format="libsvm", engine="native")
    got = []
    while True:
        b = p.next_padded(rows, nnz_bucket=nb)
        if b is None:
            break
        got.append(b.copy())
    assert len(got) == len(want)
    assert int(got[-1]["num_rows"]) < rows  # a short last batch
    for g, w in zip(got, want):
        _assert_same_dict(g, w)


def test_native_next_padded_matches_reference_engine(tmp_path, native):
    """The port's engine (its own copy, built into its own directory)
    and the reference's, loaded in one process, cut the same batches."""
    from dmlc_tpu.native import native_available as ref_native_available
    if not ref_native_available():
        pytest.skip("the reference package's native engine is not built")
    path = tmp_path / "a.libsvm"
    path.write_text(CORPORA["crlf"]())
    ref = RefParser.create(str(path), format="libsvm", engine="native")
    port = Parser.create(str(path), format="libsvm", engine="native")
    n = 0
    while True:
        want = ref.next_padded(300, nnz_bucket=300 * 9)
        got = port.next_padded(300, nnz_bucket=300 * 9)
        assert (want is None) == (got is None)
        if got is None:
            break
        _assert_same_dict(got, want)
        n += 1
    assert n == 5


@pytest.mark.parametrize("corpus", ["plain", "qid"])
def test_pad_single_and_pad_to_bucket_match_reference(tmp_path, corpus):
    path = tmp_path / "a.libsvm"
    path.write_text(CORPORA[corpus]())
    c = RowBlockContainer(np.uint32)
    for block in Parser.create(str(path), format="libsvm", engine="python"):
        c.push_block(block)
    block = c.get_block()
    want = _ref_padded(str(path), 512, 512 * 9)
    for i, s in enumerate(range(0, block.size, 512)):
        part = block.slice(s, min(s + 512, block.size))
        _assert_same_dict(pad_single(part, 512, 512 * 9), want[i])
        bucket = pad_to_bucket(part, 512, 512 * 9)
        for k in bucket:
            assert np.asarray(bucket[k]).tobytes() == \
                np.asarray(want[i][k]).tobytes(), k


def test_rowblock_to_device_keeps_layout_dtypes(tmp_path):
    path = tmp_path / "a.libsvm"
    path.write_text(CORPORA["plain"]())
    block = next(iter(Parser.create(str(path), format="libsvm",
                                    engine="python")))
    dev = block.to_device(device="cpu")
    assert dev["index"].dtype == torch.uint32
    assert dev["offset"].dtype == torch.int64
    np.testing.assert_array_equal(dev["index"].numpy(), block.index)
    np.testing.assert_array_equal(dev["value"].numpy(), block.value)
    assert dev["index"].data_ptr() != block.index.ctypes.data  # a copy


@pytest.mark.parametrize("uri", ["s3://bucket/key.libsvm",
                                 "hdfs://nn/a.libsvm"])
def test_unported_uris_raise(uri):
    with pytest.raises(DMLCError, match="not ported"):
        InputSplit.create(uri, 0, 1)


def test_cache_uri_raises(tmp_path):
    """The native engine refuses a '#cache' URI, as the reference's does
    (the split itself is ported: tests/test_torch_split_planes.py)."""
    from dmlc_tpu_torch.native import bindings
    path = tmp_path / "a.libsvm"
    path.write_text("1 1:1\n")
    with pytest.raises(DMLCError, match="not ported to the native engine"):
        bindings.NativeLibSVMParser(f"{path}#{tmp_path}/cache")


def test_registered_formats_match_the_reference():
    """Every format of the reference's parser registry is registered in
    the port (parity tests: tests/test_torch_parse.py, _libfm.py,
    _recordio.py, _csv.py and _parquet.py), and an unknown one is refused
    with the same list."""
    from dmlc_tpu.data.parser import PARSER_REGISTRY as REF_REGISTRY
    from dmlc_tpu_torch.data.parser import PARSER_REGISTRY
    want = ['csv', 'libfm', 'libsvm', 'parquet', 'parquet_native',
            'recordio_dense', 'recordio_image']
    assert sorted(PARSER_REGISTRY.list_all_names()) == want
    assert sorted(REF_REGISTRY.list_all_names()) == want
    with pytest.raises(DMLCError, match=re.escape(str(want))):
        Parser.create("x.xml", format="xml")
