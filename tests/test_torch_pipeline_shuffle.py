"""``Pipeline.shuffle`` in the port against the JAX package's.

Twins of ``tests/test_pipeline.py``'s
``test_shuffle_native_engine_rejected``,
``test_shuffle_deterministic_and_complete`` and
``test_shuffle_unsupported_format_refused``. Beyond those, the port's
shuffled padded batches (``to_device(device="cpu")``) must be
byte-identical to the reference's shuffled host chain (``prefetch`` in
place of ``to_device``) in epochs 1 and 2, whose orders differ; the
shuffled rows must be the unshuffled rows; ``shuffle`` with ``cache``
must refuse, and so must ``window_bytes`` without ``global_seed`` (the
reference's words); the global shuffle (``global_seed=``) must lower
onto a ``GlobalShuffleSplit``.
"""

import hashlib

import numpy as np
import pytest

from dmlc_tpu.data.parser import Parser as RefParser
from dmlc_tpu.data.rowblock import RowBlockContainer as RefContainer
from dmlc_tpu.pipeline import Pipeline as RefPipeline
from dmlc_tpu.utils.logging import DMLCError as RefDMLCError
from dmlc_tpu_torch.data.parser import PARSER_REGISTRY, Parser
from dmlc_tpu_torch.data.rowblock import RowBlockContainer
from dmlc_tpu_torch.pipeline import Pipeline
from dmlc_tpu_torch.utils.logging import DMLCError

BATCH, MAX_NNZ = 128, 9


def _write_libsvm(tmp_path, name="data.libsvm", rows=3000, seed=0):
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(rows):
        nnz = rng.randint(3, MAX_NNZ)
        idx = np.sort(rng.choice(500, nnz, replace=False))
        feats = " ".join(f"{j}:{v:.4f}" for j, v in zip(idx, rng.rand(nnz)))
        lines.append(f"{i % 2} {feats}")
    p = tmp_path / name
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def _drain_hash(built, container):
    c = container(np.uint32)
    for b in built:
        c.push_block(b)
    return c.get_block().content_hash()


def _batch_hash(batch):
    h = hashlib.sha256()
    for k in sorted(batch):
        a = np.ascontiguousarray(np.asarray(batch[k]))
        h.update(k.encode() + a.dtype.str.encode() + a.tobytes())
    return h.hexdigest()


def _row_hashes(batches):
    """The multiset of the padded batches' real rows, each row hashed."""
    out = []
    for b in batches:
        off = np.asarray(b["offset"])
        idx, val = np.asarray(b["index"]), np.asarray(b["value"])
        lab = np.asarray(b["label"])
        for r in range(int(b["num_rows"])):
            s, e = int(off[r]), int(off[r + 1])
            out.append(hashlib.sha256(
                lab[r].tobytes() + idx[s:e].tobytes()
                + val[s:e].tobytes()).hexdigest())
    return sorted(out)


def test_shuffle_native_engine_rejected(tmp_path):
    uri = _write_libsvm(tmp_path)
    for cls, err in ((Pipeline, DMLCError), (RefPipeline, RefDMLCError)):
        pipe = cls.from_uri(uri).shuffle().parse(engine="native")
        with pytest.raises(err, match="python parse engine"):
            pipe.build()


@pytest.mark.parametrize("parts,k", [(1, 0), (3, 2)])
def test_shuffle_deterministic_and_complete(tmp_path, parts, k):
    uri = _write_libsvm(tmp_path)

    def run(cls, container):
        built = (cls.from_uri(uri, part_index=k, num_parts=parts)
                 .shuffle(num_shuffle_parts=4, seed=11)
                 .parse(format="libsvm", chunk_size=4096).build())
        h = _drain_hash(built, container)
        rows = built.stats()["stages"][0]["rows"]
        built.close()
        return h, rows

    (h1, r1), (h2, r2) = (run(Pipeline, RowBlockContainer),
                          run(Pipeline, RowBlockContainer))
    assert h1 == h2  # same seed ⇒ same order
    assert (h1, r1) == run(RefPipeline, RefContainer)  # the reference's
    direct = Parser.create(uri, k, parts, format="libsvm")
    assert r1 == r2 == sum(b.size for b in direct)
    ref_direct = RefParser.create(uri, k, parts, format="libsvm")
    assert r1 == sum(b.size for b in ref_direct)


def test_shuffled_padded_batches_equal_reference(tmp_path):
    """Two epochs of the port's shuffled chain to the host device against
    the reference's shuffled host chain, batch for batch; each epoch's
    rows are the unshuffled chain's, in another order each epoch."""
    uri = _write_libsvm(tmp_path, rows=4000)
    chain = dict(num_shuffle_parts=8, seed=7)
    parse = dict(format="libsvm", chunk_size=4096)
    pad = dict(pad=True, nnz_bucket=BATCH * MAX_NNZ)
    port = (Pipeline.from_uri(uri).shuffle(**chain).parse(**parse)
            .batch(BATCH, **pad).to_device(device="cpu").build())
    ref = (RefPipeline.from_uri(uri).shuffle(**chain).parse(**parse)
           .batch(BATCH, **pad).prefetch(depth=2).build())
    plain = (Pipeline.from_uri(uri).parse(engine="python", **parse)
             .batch(BATCH, **pad).to_device(device="cpu").build())
    unshuffled = _row_hashes(plain)
    epochs = []
    for _ in range(2):
        got = [_batch_hash({k: v.numpy() for k, v in b.items()})
               for b in port]
        want = [_batch_hash(b) for b in ref]
        assert got == want
        epochs.append(got)
        stages = {st["name"]: st for st in port.stats()["stages"]}
        assert stages["assemble"]["extra"]["assembly_path"] \
            == "python-fused"
    assert epochs[0] != epochs[1]  # reshuffled
    rows = [_row_hashes(port), _row_hashes(port)]
    assert rows[0] == rows[1] == unshuffled
    for b in (port, ref, plain):
        b.close()


def test_shuffle_with_one_part_is_the_plain_order(tmp_path):
    uri = _write_libsvm(tmp_path, rows=900)
    built = (Pipeline.from_uri(uri).shuffle(num_shuffle_parts=1, seed=3)
             .parse(format="libsvm").build())
    direct = (Pipeline.from_uri(uri).parse(format="libsvm", engine="python")
              .build())
    assert (_drain_hash(built, RowBlockContainer)
            == _drain_hash(direct, RowBlockContainer))
    built.close()
    direct.close()


@pytest.fixture
def ignoring_format():
    """A parser format that ignores the injected split, as the
    reference's parquet parser does."""
    from dmlc_tpu_torch.data.libsvm_parser import LibSVMParser

    def make(**kwargs):
        kwargs.pop("split_factory", None)
        kwargs.pop("engine", None)
        return LibSVMParser(**kwargs)

    PARSER_REGISTRY.register("ignores_split", make)
    yield "ignores_split"
    PARSER_REGISTRY.remove("ignores_split")


def test_shuffle_unsupported_format_refused(tmp_path, ignoring_format):
    uri = _write_libsvm(tmp_path, rows=200)
    pipe = (Pipeline.from_uri(uri).shuffle(num_shuffle_parts=2)
            .parse(format=ignoring_format))
    # silently yielding UNshuffled data would be worse than an error
    with pytest.raises(DMLCError, match="shuffle is not supported"):
        pipe.build()
    pytest.importorskip("pyarrow")
    import pyarrow as pa
    import pyarrow.parquet as pq
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"label": pa.array([0.0, 1.0]),
                             "f0": pa.array([0.5, 0.25])}), path)
    ref = (RefPipeline.from_uri(path).shuffle(num_shuffle_parts=2)
           .parse(format="parquet", label_column="label"))
    with pytest.raises(RefDMLCError, match="shuffle is not supported"):
        ref.build()


@pytest.mark.parametrize("kwargs", [{"global_seed": 3},
                                    {"global_seed": 3, "window_bytes": 1024},
                                    {"window_bytes": 1024}])
def test_global_shuffle_is_not_ported(tmp_path, kwargs):
    """(Named when the port refused the global shuffle.) ``global_seed``
    now adds a shuffle spec carrying the seed and window the lowering
    reads, as the reference's ``shuffle`` does; ``window_bytes`` alone
    is refused in both packages with the reference's words."""
    if "global_seed" not in kwargs:
        for pipeline_cls, err in ((Pipeline, DMLCError),
                                  (RefPipeline, RefDMLCError)):
            with pytest.raises(err, match="pass global_seed"):
                pipeline_cls.from_uri("x.libsvm").shuffle(**kwargs)
        return
    spec = Pipeline.from_uri("x.libsvm").shuffle(**kwargs).stages[-1]
    ref = RefPipeline.from_uri("x.libsvm").shuffle(**kwargs).stages[-1]
    assert spec.kind == ref.kind == "shuffle"
    assert dict(spec.params) == dict(ref.params)
    assert spec.params["global_seed"] == 3
    assert spec.params["window_bytes"] == kwargs.get("window_bytes")


def test_global_shuffle_spec_refused_at_build(tmp_path):
    """(Named when the port refused the global shuffle.) A chain whose
    shuffle spec carries a global seed (built from specs, not through
    ``shuffle()``) lowers onto a GlobalShuffleSplit at that seed and the
    default window, never a chunk shuffle: its rows are the file's rows
    in the reference's global order."""
    from dmlc_tpu.pipeline import StageSpec as RefStageSpec
    from dmlc_tpu_torch import shuffle
    from dmlc_tpu_torch.pipeline import StageSpec
    uri = _write_libsvm(tmp_path, rows=100)

    def specs(cls):
        return (cls("source", uri=uri, part_index=0, num_parts=1,
                    split_type="text"),
                cls("shuffle", num_shuffle_parts=2, seed=0, global_seed=3,
                    window_bytes=None),
                cls("parse", format="libsvm", engine="python"))

    with Pipeline(specs(StageSpec)).build() as built:
        got = _drain_hash(built, RowBlockContainer)
        v = shuffle.view()
        assert (v["seed"], v["window_bytes"], v["records"]) == \
            (3, shuffle.DEFAULT_WINDOW_BYTES, 100)
    with RefPipeline(specs(RefStageSpec)).build() as built:
        assert got == _drain_hash(built, RefContainer)


def test_shuffle_with_cache_refuses(tmp_path):
    uri = _write_libsvm(tmp_path, rows=200)
    for cls, err in ((Pipeline, DMLCError), (RefPipeline, RefDMLCError)):
        pipe = (cls.from_uri(uri).shuffle(num_shuffle_parts=2)
                .parse(format="libsvm", engine="python").cache())
        with pytest.raises(err, match="shuffle \\+ cache is not lowerable"):
            pipe.build()


def test_split_factory_forces_the_python_golden(tmp_path):
    """A custom split under engine='auto' parses with the python golden;
    engine='native' with one raises the reference's error."""
    from dmlc_tpu_torch.data.libsvm_parser import LibSVMParser
    from dmlc_tpu_torch.io.input_split import InputSplit
    uri = _write_libsvm(tmp_path, rows=300)
    p = Parser.create(uri, format="libsvm",
                      split_factory=lambda: InputSplit.create(uri, 0, 1))
    assert isinstance(p, LibSVMParser)
    assert sum(b.size for b in p) == 300
    p.destroy()
    msg = "native engine does not accept split_factory"
    with pytest.raises(DMLCError, match=msg):
        Parser.create(uri, format="libsvm", engine="native",
                      split_factory=lambda: None)
    with pytest.raises(RefDMLCError, match=msg):
        RefParser.create(uri, format="libsvm", engine="native",
                         split_factory=lambda: None)
