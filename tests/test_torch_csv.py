"""The csv format of the port against the JAX package's.

The port's ``CSVParser`` (Python golden) and ``NativeCSVParser`` (the
engine's csv lane) must give the reference's CSR byte for byte
(``RowBlock.content_hash()``): dense and sparse (zero cells dropped,
indices keeping the column ordinal), a label and a weight column,
delimiters, CRLF, whole, in parts and sharded; a ragged row is refused
as the reference refuses it. The engine's padded batches equal the
reference's ``pad_single`` over its blocks. Then the slice: a
HIGGS-shaped csv (label + 28 columns) through the port's ``Pipeline``
into ``SparseLinearModel(28)`` on the CPU, 3 steps against the
reference's ``SparseLinearModel`` from the same batches and weights, at
rtol 1e-5 and atol 1e-6 (fp32 on both sides, sums in other orders).
"""

import numpy as np
import pytest

from dmlc_tpu.data.padding import pad_single as ref_pad_single
from dmlc_tpu.data.parser import Parser as RefParser
from dmlc_tpu.data.rowblock import RowBlockContainer as RefContainer
from dmlc_tpu.models.linear import SparseLinearModel as RefModel
from dmlc_tpu.pipeline import Pipeline as RefPipeline
from dmlc_tpu.utils.logging import DMLCError as RefDMLCError
from dmlc_tpu_torch.convert import params_from_jax, params_to_numpy
from dmlc_tpu_torch.data.padding import pad_single
from dmlc_tpu_torch.data.parser import Parser
from dmlc_tpu_torch.data.rowblock import RowBlockContainer
from dmlc_tpu_torch.models.linear import SparseLinearModel
from dmlc_tpu_torch.native import bindings, native_available
from dmlc_tpu_torch.pipeline import Pipeline
from dmlc_tpu_torch.utils.logging import DMLCError

RTOL, ATOL = 1e-5, 1e-6
FEATURES = 28


def higgs_lines(rows=1200, seed=0, zero_frac=0.0):
    """HIGGS-shaped rows: a {0, 1} label drawn with the probability a
    seeded hidden weight vector gives the centred row, then 28 cells
    written ``%.6f``; ``zero_frac`` of the cells exactly zero."""
    rng = np.random.RandomState(seed)
    w_true = rng.standard_normal(FEATURES)
    vals = rng.rand(rows, FEATURES)
    vals[rng.rand(rows, FEATURES) < zero_frac] = 0.0
    p = 1 / (1 + np.exp(-((vals - 0.5) @ w_true)))
    labels = (rng.rand(rows) < p).astype(int)
    return [f"{y}," + ",".join(f"{v:.6f}" for v in row)
            for y, row in zip(labels, vals)]


def _delimited(delim, rows=300, seed=3):
    rng = np.random.RandomState(seed)
    return [delim.join(f"{rng.randn():.5g}" for _ in range(6))
            for _ in range(rows)]


# corpus name -> (file text, parse kwargs)
CORPORA = {
    "dense": (lambda: "\n".join(higgs_lines()) + "\n", {"label_column": 0}),
    "sparse": (lambda: "\n".join(higgs_lines(seed=1, zero_frac=0.3)) + "\n",
               {"label_column": 0, "sparse": True}),
    "zeros_kept": (lambda: "\n".join(higgs_lines(seed=1, zero_frac=0.3))
                   + "\n", {"label_column": 0}),
    "crlf": (lambda: "\r\n".join(higgs_lines(seed=2)) + "\r\n",
             {"label_column": 0}),
    "no_label": (lambda: "\n".join(higgs_lines(seed=4, rows=200)),
                 {}),
    "label_last": (lambda: "\n".join(higgs_lines(seed=5, rows=300)) + "\n",
                   {"label_column": 28}),
    "weight": (lambda: "\n".join(higgs_lines(seed=6, rows=300)) + "\n",
               {"label_column": 0, "weight_column": 3}),
    "tab": (lambda: "\n".join(_delimited("\t")) + "\n",
            {"label_column": 0, "delimiter": "\t"}),
    "semicolon": (lambda: "\n".join(_delimited(";")) + "\n",
                  {"label_column": 0, "delimiter": ";"}),
    "exotic_e": (lambda: "1e23e4.5e67\n67e4.5e23e1\n",
                 {"label_column": 0, "delimiter": "e"}),
}


@pytest.fixture(scope="module")
def native():
    if not native_available():
        pytest.fail("the port's native engine did not build")
    return True


def _write(tmp_path, name):
    text, kw = CORPORA[name]
    path = tmp_path / f"{name}.csv"
    path.write_bytes(text().encode())
    return str(path), kw


def _port_block(path, part=0, parts=1, **kw):
    c = RowBlockContainer(np.uint32)
    p = Parser.create(path, part, parts, format="csv", **kw)
    for b in p:
        c.push_block(b)
    p.destroy()
    return c.get_block()


def _ref_block(path, part=0, parts=1, **kw):
    c = RefContainer(np.uint32)
    p = RefParser.create(path, part, parts, format="csv", engine="python",
                         **kw)
    for b in p:
        c.push_block(b)
    return c.get_block()


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("engine", ["python", "native"])
def test_content_hash_matches_reference(tmp_path, corpus, engine, native):
    path, kw = _write(tmp_path, corpus)
    p = Parser.create(path, format="csv", engine=engine, **kw)
    assert isinstance(p, bindings.NativeCSVParser) == (engine == "native")
    p.destroy()
    got = _port_block(path, engine=engine, **kw)
    want = _ref_block(path, **kw)
    assert got.content_hash() == want.content_hash()
    assert got.size == want.size > 0


def test_sparse_drops_zero_cells_and_keeps_ordinals(tmp_path, native):
    path, kw = _write(tmp_path, "sparse")
    sparse = _port_block(path, engine="native", **kw)
    dense = _port_block(path, engine="native", label_column=0)
    assert (sparse.value != 0).all() and sparse.size == dense.size
    keep = dense.value != 0
    assert sparse.nnz == int(keep.sum()) < dense.nnz
    np.testing.assert_array_equal(sparse.index, dense.index[keep])
    assert dense.index.max() == FEATURES - 1


@pytest.mark.parametrize("engine", ["python", "native"])
def test_ragged_row_is_refused_as_the_reference_refuses_it(tmp_path, engine,
                                                           native):
    path = tmp_path / "r.csv"
    path.write_bytes(b"1,2,3\n4,5\n")
    with pytest.raises(RefDMLCError, match="non-uniform number of columns"):
        _ref_block(str(path))
    with pytest.raises(DMLCError, match="non-uniform number of columns"):
        _port_block(str(path), engine=engine)


@pytest.mark.parametrize("cell", ["1.2.3", "1e", "+", "1e+"])
@pytest.mark.parametrize("engine", ["python", "native"])
def test_malformed_cells_are_refused(tmp_path, cell, engine, native):
    path = tmp_path / "bad.csv"
    path.write_bytes(f"1,{cell},3\n".encode())
    with pytest.raises((RefDMLCError, ValueError)):
        _ref_block(str(path), label_column=0)
    with pytest.raises((DMLCError, ValueError)):
        _port_block(str(path), engine=engine, label_column=0)


@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("part", range(4))
def test_parts_match_reference(tmp_path, engine, part, native):
    path, kw = _write(tmp_path, "crlf")
    got = _port_block(path, part, 4, engine=engine, chunk_size=16 << 10,
                      **kw)
    assert got.content_hash() == _ref_block(path, part, 4,
                                            **kw).content_hash()


@pytest.mark.parametrize("corpus", ["dense", "sparse"])
@pytest.mark.parametrize("shards", [2, 3])
def test_shards_equal_the_one_parser_stream(tmp_path, corpus, shards,
                                            native):
    path, kw = _write(tmp_path, corpus)
    p = Parser.create(path, format="csv", engine="native", shards=shards,
                      chunk_size=16 << 10, **kw)
    assert isinstance(p, bindings.NativeShardedTextParser)
    p.destroy()
    got = _port_block(path, engine="native", shards=shards,
                      chunk_size=16 << 10, **kw)
    assert got.content_hash() == _ref_block(path, **kw).content_hash()


def _assert_same_dict(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("corpus", ["dense", "sparse"])
@pytest.mark.parametrize("shards", [None, 2])
def test_native_padded_batches_equal_pad_single(tmp_path, corpus, shards,
                                                native):
    """The engine's padded batches (one parser, and the gang of 2) equal
    the reference's ``pad_single`` and the port's over the Python
    golden's rows, byte for byte."""
    path, kw = _write(tmp_path, corpus)
    rows, nb = 256, 256 * FEATURES
    ref = _ref_block(path, **kw)
    golden = _port_block(path, engine="python", **kw)
    extra = {"shards": shards} if shards else {}
    p = Parser.create(path, format="csv", engine="native",
                      chunk_size=16 << 10, **extra, **kw)
    got = []
    while True:
        b = p.next_padded(rows, nnz_bucket=nb)
        if b is None:
            break
        got.append({k: np.array(v) for k, v in b.items()})
    assert p.outstanding() <= 1
    p.destroy()
    starts = range(0, ref.size, rows)
    assert len(got) == len(starts) == 5
    for i, s in enumerate(starts):
        want = ref_pad_single(ref.slice(s, min(s + rows, ref.size)), rows,
                              nb)
        _assert_same_dict(got[i], want)
        _assert_same_dict(got[i], pad_single(
            golden.slice(s, min(s + rows, golden.size)), rows, nb))


# ------------------------------------------------------------ the slice

STEPS, ROW_BUCKET, LEARNING_RATE = 3, 256, 0.5


def _ref_batches(path):
    built = (RefPipeline.from_uri(path)
             .parse(format="csv", engine="python", label_column=0)
             .batch(ROW_BUCKET, pad=True, nnz_bucket=ROW_BUCKET * FEATURES)
             .build())
    out = [{k: np.array(v) for k, v in b.items()} for b in built]
    built.close()
    return out


@pytest.mark.parametrize("engine,shards", [
    ("python", None), ("native", None), ("native", 2)])
def test_slice_trains_like_the_reference(tmp_path, engine, shards, native):
    path, _ = _write(tmp_path, "dense")
    want_batches = _ref_batches(path)
    rng = np.random.RandomState(11)
    init = {"w": (rng.standard_normal(FEATURES) * 0.1).astype(np.float32),
            "b": np.float32(0.05)}
    ref = RefModel(FEATURES, learning_rate=LEARNING_RATE)
    params = dict(init)
    want_losses = []
    for batch in want_batches[:STEPS]:
        params, loss = ref.train_step(params, batch)
        want_losses.append(float(loss))

    kw = {"shards": shards} if shards else {}
    built = (Pipeline.from_uri(path)
             .parse(format="csv", engine=engine, label_column=0, **kw)
             .batch(ROW_BUCKET, pad=True, nnz_bucket=ROW_BUCKET * FEATURES)
             .to_device(device="cpu")
             .build())
    model = SparseLinearModel(FEATURES, learning_rate=LEARNING_RATE,
                              device="cpu")
    model.load_state_dict(params_from_jax(init, device="cpu"), strict=True)
    losses = []
    for i, batch in enumerate(built):  # the whole epoch: then its stats
        host = {k: v.numpy() for k, v in batch.items()}
        _assert_same_dict(host, want_batches[i])
        if i < STEPS:
            losses.append(float(model.train_step(batch)))
    assert i + 1 == len(want_batches)
    apath = next(st["extra"]["assembly_path"]
                 for st in built.stats()["stages"]
                 if "assembly_path" in st.get("extra", {}))
    built.close()
    assert apath == ("python-fused" if engine == "python"
                     else "native-padded")
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)
    got = params_to_numpy(model.state_dict())
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k], np.asarray(params[k]), rtol=RTOL,
                                   atol=ATOL)
