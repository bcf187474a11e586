"""The libfm path of the port's host plane against the JAX package's.

The port's libfm parser (its Python golden and the native engine, which
parses libfm in its verbatim engine.cc) must give blocks whose
``RowBlock.content_hash()`` (which covers ``field``) equals that of
``dmlc_tpu``'s ``LibFMParser``, whole and sharded; its padded batches
with ``field`` (native ``next_padded(want_field=True)``, ``pad_single``,
``pad_to_bucket``) must be byte-identical to the reference's. The last
test drives the slice end to end on the CPU: libfm text → the port's
parser → ``device_prefetch`` → FM and FFM steps, against the reference's
parser → ``pad_single`` → ``train_step`` (rtol 1e-5, atol 1e-6: fp32 on
both sides, sums in other orders).
"""

import numpy as np
import pytest

from dmlc_tpu.data.padding import pad_single as ref_pad_single
from dmlc_tpu.data.parser import Parser as RefParser
from dmlc_tpu.data.rowblock import RowBlockContainer as RefContainer
from dmlc_tpu.models.fm import SparseFFMModel as RefFFM
from dmlc_tpu.models.fm import SparseFMModel as RefFM
from dmlc_tpu.parallel import pad_to_bucket as ref_pad_to_bucket
from dmlc_tpu_torch.convert import params_from_jax, params_to_numpy
from dmlc_tpu_torch.data.libfm_parser import LibFMParser
from dmlc_tpu_torch.data.padding import pad_single, pad_to_bucket
from dmlc_tpu_torch.data.parser import Parser
from dmlc_tpu_torch.data.rowblock import RowBlockContainer
from dmlc_tpu_torch.models import SparseFFMModel, SparseFMModel
from dmlc_tpu_torch.native import native_available
from dmlc_tpu_torch.native.bindings import NativeLibFMParser
from dmlc_tpu_torch.parallel.device_iter import device_prefetch
from dmlc_tpu_torch.utils.logging import DMLCError

FEATURES, FIELDS = 3000, 6


def _lines(rows=1500, seed=0, one_based=False, max_fields=FIELDS):
    """Criteo-like libfm rows: a random subset of the fields, each with
    one or two features, categorical fields valued 1 and the others a
    float."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(rows):
        fields = np.sort(rng.choice(FIELDS, rng.randint(0, max_fields + 1),
                                    replace=False))
        toks = []
        for f in fields:
            for j in rng.choice(FEATURES, rng.randint(1, 3), replace=False):
                v = "1" if f % 2 else f"{rng.rand():.6f}"
                toks.append(f"{f}:{int(j) + int(one_based)}:{v}")
        out.append(f"{(-1) ** i} {' '.join(toks)}".rstrip())
    return out


CORPORA = {
    "plain": lambda: "\n".join(_lines()) + "\n",
    "crlf": lambda: "\r\n".join(_lines(seed=1)) + "\r\n",
    "empty_lines": lambda: "\n\n".join(_lines(seed=2)) + "\n\n\n",
    "no_trailing_newline": lambda: "\n".join(_lines(seed=3)),
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
    return _hash(RefParser.create(path, part, parts, format="libfm",
                                  engine="python", **kw), RefContainer)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("engine", ["python", "native"])
def test_whole_file_content_hash(tmp_path, corpus, engine, native):
    path = tmp_path / "a.libfm"
    path.write_text(CORPORA[corpus]())
    p = Parser.create(str(path), format="libfm", engine=engine)
    assert isinstance(p, NativeLibFMParser if engine == "native"
                      else LibFMParser)
    assert _hash(p, RowBlockContainer) == _ref_hash(str(path))


@pytest.mark.parametrize("engine", ["python", "native"])
def test_four_way_sharded_content_hash(tmp_path, engine, native):
    """Each of 4 byte-range parts matches the reference's part, and the
    parts concatenate to the whole file."""
    path = tmp_path / "a.libfm"
    path.write_text("\n".join(_lines(rows=3000, seed=5)) + "\n")
    whole = RowBlockContainer(np.uint32)
    for part in range(4):
        p = Parser.create(str(path), part, 4, format="libfm", engine=engine,
                          chunk_size=64 << 10)
        c = RowBlockContainer(np.uint32)
        for block in p:
            c.push_block(block)
            whole.push_block(block)
        assert c.get_block().content_hash() == _ref_hash(str(path), part, 4)
    assert whole.get_block().content_hash() == _ref_hash(str(path))


@pytest.mark.parametrize("mode", [1, -1])
@pytest.mark.parametrize("engine", ["python", "native"])
def test_indexing_mode(tmp_path, mode, engine, native):
    path = tmp_path / "one.libfm"
    path.write_text("\n".join(_lines(seed=6, one_based=True)) + "\n")
    p = Parser.create(str(path), format="libfm", engine=engine,
                      indexing_mode=mode)
    assert (_hash(p, RowBlockContainer)
            == _ref_hash(str(path), indexing_mode=mode))


def test_indexing_mode_one_rejects_zero(tmp_path):
    path = tmp_path / "z.libfm"
    path.write_text("1 0:0:1.0 1:3:2.0\n")
    with pytest.raises(DMLCError, match="index 0"):
        list(Parser.create(str(path), format="libfm", engine="python",
                           indexing_mode=1))


@pytest.mark.parametrize("engine", ["python", "native"])
def test_bad_token_raises(tmp_path, engine, native):
    path = tmp_path / "bad.libfm"
    path.write_text("1 0:3:1.0 7:2.0\n")
    with pytest.raises(DMLCError):
        list(Parser.create(str(path), format="libfm", engine=engine))


def _ref_block(path):
    c = RefContainer(np.uint32)
    for block in RefParser.create(path, format="libfm", engine="python"):
        c.push_block(block)
    return c.get_block()


def _assert_same_dict(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("corpus", ["plain", "crlf"])
def test_native_next_padded_with_field_matches_reference(tmp_path, corpus,
                                                         native):
    path = tmp_path / "a.libfm"
    path.write_text(CORPORA[corpus]())
    rows, nb = 256, 256 * 12
    block = _ref_block(str(path))
    want = [ref_pad_to_bucket(block.slice(s, min(s + rows, block.size)),
                              rows, nb)
            for s in range(0, block.size, rows)]
    p = Parser.create(str(path), format="libfm", engine="native")
    got = []
    while True:
        b = p.next_padded(rows, nnz_bucket=nb, want_field=True)
        if b is None:
            break
        got.append(b.copy())
    assert len(got) == len(want)
    assert int(got[-1]["num_rows"]) < rows  # a short last batch
    for g, w in zip(got, want):
        assert "field" in g
        _assert_same_dict(g, w)


def test_pad_single_and_pad_to_bucket_carry_field(tmp_path):
    path = tmp_path / "a.libfm"
    path.write_text(CORPORA["plain"]())
    c = RowBlockContainer(np.uint32)
    for block in Parser.create(str(path), format="libfm", engine="python"):
        c.push_block(block)
    block = c.get_block()
    ref = _ref_block(str(path))
    for s in range(0, block.size, 512):
        e = min(s + 512, block.size)
        want = ref_pad_single(ref.slice(s, e), 512, 512 * 12,
                              want_field=True)
        _assert_same_dict(pad_single(block.slice(s, e), 512, 512 * 12,
                                     want_field=True), want)
        _assert_same_dict(pad_to_bucket(block.slice(s, e), 512, 512 * 12),
                          ref_pad_to_bucket(ref.slice(s, e), 512, 512 * 12))


@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("ffm", [False, True], ids=["fm", "ffm"])
def test_slice_end_to_end(tmp_path, ffm, engine, native):
    """libfm text → parser → padded batches → device_prefetch (CPU,
    staging) → 4 SGD steps, against the reference's parser → pad_single
    → train_step from the same converted parameters: the reference's
    ``init_params`` with w drawn at random, so that no margin is 0 (at a
    margin of 0 the reference's subgradient depends on XLA's rounding,
    ROADMAP C5)."""
    path = tmp_path / "train.libfm"
    path.write_text("\n".join(_lines(rows=1000, seed=7)) + "\n")
    rows, nb = 256, 256 * 12
    if ffm:
        ref = RefFFM(FEATURES, FIELDS, learning_rate=2.0)
        port = SparseFFMModel(FEATURES, FIELDS, learning_rate=2.0,
                              device="cpu")
    else:
        ref = RefFM(FEATURES, learning_rate=2.0, init_scale=0.05)
        port = SparseFMModel(FEATURES, learning_rate=2.0, device="cpu")
    params = {k: np.asarray(v) for k, v in ref.init_params(seed=4).items()}
    params["w"] = (0.1 * np.random.RandomState(4).randn(FEATURES)
                   ).astype(np.float32)
    port.load_state_dict(params_from_jax(params, device="cpu"))

    block = _ref_block(str(path))
    want = []
    for s in range(0, block.size, rows):
        batch = dict(ref_pad_single(
            block.slice(s, min(s + rows, block.size)), rows, nb,
            want_field=True))
        params, loss = ref.train_step(params, batch)
        want.append(float(loss))

    parser = Parser.create(str(path), format="libfm", engine=engine)
    if engine == "native":
        host = iter(lambda: parser.next_padded(rows, nnz_bucket=nb,
                                               want_field=True), None)
    else:
        host = (pad_single(b.slice(s, min(s + rows, b.size)), rows, nb,
                           want_field=True)
                for b in [_port_block(parser)]
                for s in range(0, b.size, rows))
    got = []
    for batch in device_prefetch(host, device="cpu", staging=True):
        if ffm:
            port.validate_batch(batch)
        got.append(float(port.train_step(batch)))
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    new = params_to_numpy(port.state_dict())
    for k in ("w", "b", "V"):
        np.testing.assert_allclose(new[k], np.asarray(params[k]), rtol=1e-5,
                                   atol=1e-6)


def _port_block(parser):
    c = RowBlockContainer(np.uint32)
    for block in parser:
        c.push_block(block)
    return c.get_block()
