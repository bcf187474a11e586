"""The linear model trained from a dense ``.rec`` through the port's
``Pipeline``, against the JAX package's.

A dense RecordIO corpus (24-48 values a row, labels in {0, 1} drawn from
a seeded logistic model), written by the port's ``DenseRecordWriter``,
goes through ``Pipeline.from_uri(rec).parse(format="recordio_dense")
.batch(pad=True).to_device(device="cpu")`` into
``SparseLinearModel(48).train_step`` (the kernels' plain versions on the
CPU), and through the reference's ``Pipeline`` (its host padded batches)
into its jitted ``train_step`` on JAX's CPU, from the same zero weights.
Every step's loss and the final w and b agree at rtol 1e-5, atol 1e-6:
fp32 on both sides, the sums in other orders (ROADMAP C3).
"""

import numpy as np
import pytest
import torch

from dmlc_tpu.io import recordio as ref_rio
from dmlc_tpu.io.stream import create_stream as ref_create_stream
from dmlc_tpu.models.linear import SparseLinearModel as RefModel
from dmlc_tpu.pipeline import Pipeline as RefPipeline
from dmlc_tpu_torch.convert import params_to_numpy
from dmlc_tpu_torch.io.recordio import DenseRecordWriter
from dmlc_tpu_torch.io.stream import create_stream
from dmlc_tpu_torch.models.linear import SparseLinearModel
from dmlc_tpu_torch.native import native_available
from dmlc_tpu_torch.pipeline import Pipeline

RTOL, ATOL = 1e-5, 1e-6
ROWS, FEATURES, ROW_BUCKET = 1500, 48, 256
NNZ_BUCKET = ROW_BUCKET * FEATURES
LEARNING_RATE = 0.5


def _rows(seed=0):
    """(label, values) rows: 24-48 values in [0, 1), the label 1 with
    the probability a seeded hidden weight vector gives the row."""
    rng = np.random.RandomState(seed)
    w_true = rng.standard_normal(FEATURES).astype(np.float32)
    out = []
    for _ in range(ROWS):
        vals = rng.rand(int(rng.randint(24, 49))).astype(np.float32)
        p = 1 / (1 + np.exp(-(vals @ w_true[:vals.size]) / 4))
        out.append((float(rng.rand() < p), vals))
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("dense") / "train.rec"
    with create_stream(str(path), "w") as s:
        w = DenseRecordWriter(s)
        for label, vals in _rows():
            w.write(label, vals)
    return str(path)


def test_corpus_is_the_reference_writers(corpus, tmp_path):
    ref = tmp_path / "ref.rec"
    with ref_create_stream(str(ref), "w") as s:
        w = ref_rio.DenseRecordWriter(s)
        for label, vals in _rows():
            w.write(label, vals)
    assert ref.read_bytes() == open(corpus, "rb").read()


def _reference_run(path):
    built = (RefPipeline.from_uri(path)
             .parse(format="recordio_dense", engine="python")
             .batch(ROW_BUCKET, pad=True, nnz_bucket=NNZ_BUCKET)
             .build())
    model = RefModel(FEATURES, learning_rate=LEARNING_RATE)
    params = {k: np.asarray(v) for k, v in model.init_params().items()}
    losses = []
    for batch in built:
        params, loss = model.train_step(
            params, {k: np.array(v) for k, v in batch.items()})
        losses.append(float(loss))
    built.close()
    return losses, {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def reference(corpus):
    return _reference_run(corpus)


@pytest.mark.parametrize("engine,shards", [
    ("python", None), ("native", None), ("native", 2)])
def test_epoch_matches_jax(corpus, reference, engine, shards):
    if engine == "native" and not native_available():
        pytest.fail("the port's native engine did not build")
    want_losses, want_params = reference
    kw = {"shards": shards} if shards else {}
    built = (Pipeline.from_uri(f"cuda://{corpus}")
             .parse(format="recordio_dense", engine=engine, **kw)
             .batch(ROW_BUCKET, pad=True, nnz_bucket=NNZ_BUCKET)
             .to_device(device="cpu")
             .build())
    model = SparseLinearModel(FEATURES, learning_rate=LEARNING_RATE,
                              device="cpu")
    losses = []
    for batch in built:
        assert batch["index"].dtype == torch.uint32
        assert batch["value"].shape == (NNZ_BUCKET,)
        losses.append(float(model.train_step(batch)))
    apath = next(s["extra"]["assembly_path"]
                 for s in built.stats()["stages"]
                 if "assembly_path" in s.get("extra", {}))
    built.close()
    assert apath == ("python-fused" if engine == "python"
                     else "native-padded")
    assert len(losses) == -(-ROWS // ROW_BUCKET)  # a short last batch too
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)
    got = params_to_numpy(model.state_dict())
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k], want_params[k], rtol=RTOL,
                                   atol=ATOL)
    assert losses[-1] < losses[0]  # the labels are learnable
    assert np.abs(got["w"]).max() > 0
