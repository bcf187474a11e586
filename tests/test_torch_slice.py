"""The port's main path as a whole, against the JAX package's.

libsvm file → the port's parser (native ``next_padded``, or the Python
parser + ``pad_single``) → ``device_prefetch(device="cpu", staging=True)``
→ 5 SGD steps of the port's SparseLinearModel, compared with dmlc_tpu's
Parser → ``pad_single`` → ``SparseLinearModel.train_step`` from the same
(zero) weights. Losses and the final w agree at rtol=1e-5, atol=1e-6:
CPU fp32 on both sides, the CSR sums in different orders. Also the
host→device iterator's own contract.
"""

import numpy as np
import pytest
import torch

from dmlc_tpu.data.padding import pad_single as ref_pad_single
from dmlc_tpu.data.parser import Parser as RefParser
from dmlc_tpu.data.rowblock import RowBlockContainer as RefContainer
from dmlc_tpu.models.linear import SparseLinearModel as RefModel
from dmlc_tpu_torch.convert import params_from_jax, params_to_numpy
from dmlc_tpu_torch.data.padding import pad_single
from dmlc_tpu_torch.data.parser import Parser
from dmlc_tpu_torch.data.rowblock import RowBlockContainer
from dmlc_tpu_torch.models.linear import SparseLinearModel
from dmlc_tpu_torch.native import native_available
from dmlc_tpu_torch.parallel.device_iter import (
    DeviceIter, HostStaging, device_prefetch)

RTOL, ATOL = 1e-5, 1e-6
ROWS, FEATURES, ROW_BUCKET, MAX_NNZ = 2000, 4096, 256, 12
NNZ_BUCKET = ROW_BUCKET * MAX_NNZ
STEPS = 5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """2000 libsvm rows, labels from a seeded hidden weight vector."""
    rng = np.random.RandomState(0)
    w_true = np.random.RandomState(7).randn(FEATURES)
    lines = []
    for _ in range(ROWS):
        nnz = rng.randint(1, MAX_NNZ + 1)
        idx = np.sort(rng.choice(FEATURES, nnz, replace=False))
        vals = rng.rand(nnz)
        y = 1 if (vals * w_true[idx]).sum() > 0 else -1
        lines.append(f"{y} " + " ".join(
            f"{j}:{v:.6f}" for j, v in zip(idx, vals)))
    path = tmp_path_factory.mktemp("slice") / "train.libsvm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _blocks_to_padded(block, pad):
    return [pad(block.slice(s, min(s + ROW_BUCKET, block.size)),
                ROW_BUCKET, NNZ_BUCKET)
            for s in range(0, block.size, ROW_BUCKET)]


def _reference_run(path):
    c = RefContainer(np.uint32)
    for block in RefParser.create(path, format="libsvm", engine="python"):
        c.push_block(block)
    batches = _blocks_to_padded(c.get_block(), ref_pad_single)[:STEPS]
    model = RefModel(FEATURES, learning_rate=2.0)
    params = {k: np.asarray(v) for k, v in model.init_params().items()}
    losses = []
    for batch in batches:
        params, loss = model.train_step(params, dict(batch))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in params.items()}


def _port_batches(path, engine):
    if engine == "native":
        parser = Parser.create(path, format="libsvm", engine="native")
        while True:
            batch = parser.next_padded(ROW_BUCKET, nnz_bucket=NNZ_BUCKET)
            if batch is None:
                return
            yield batch  # leased views: staging copies them before next()
    else:
        c = RowBlockContainer(np.uint32)
        for block in Parser.create(path, format="libsvm", engine="python"):
            c.push_block(block)
        yield from _blocks_to_padded(c.get_block(), pad_single)


@pytest.mark.parametrize("engine", ["python", "native"])
def test_five_steps_match_jax(corpus, engine):
    if engine == "native" and not native_available():
        pytest.fail("the port's native engine did not build")
    want_losses, want_params = _reference_run(corpus)
    model = SparseLinearModel(FEATURES, learning_rate=2.0, device="cpu")
    model.load_state_dict(params_from_jax(
        {"w": np.zeros(FEATURES, np.float32), "b": np.float32(0)},
        device="cpu"))
    losses = []
    for batch in device_prefetch(_port_batches(corpus, engine), size=2,
                                 device="cpu", staging=True):
        assert batch["index"].dtype == torch.uint32
        losses.append(float(model.train_step(batch)))
        if len(losses) == STEPS:
            break
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)
    got = params_to_numpy(model.state_dict())
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k], want_params[k], rtol=RTOL,
                                   atol=ATOL)
    assert np.abs(got["w"]).max() > 0  # the steps did move the weights


def _batches(n=7, seed=42):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(4).astype(np.float32),
             "index": np.arange(5, dtype=np.uint32) + i,
             "num_rows": np.int32(i)} for i in range(n)]


@pytest.mark.parametrize("staging", [False, True])
@pytest.mark.parametrize("size", [1, 3])
def test_device_prefetch_preserves_order_and_values(staging, size):
    batches = _batches()
    out = list(device_prefetch(iter(batches), size=size, device="cpu",
                               staging=staging))
    assert len(out) == len(batches)
    for a, b in zip(batches, out):
        assert sorted(a) == sorted(b)
        np.testing.assert_array_equal(b["x"].numpy(), a["x"])
        np.testing.assert_array_equal(b["index"].numpy(), a["index"])
        assert b["index"].dtype == torch.uint32
        assert int(b["num_rows"]) == int(a["num_rows"])


def test_staged_batches_do_not_alias_their_source():
    """staging=True copies each batch when it is pulled: overwriting the
    source afterwards (a native arena recycled by the next pull) leaves
    the yielded batch intact."""
    buf = np.zeros(6, np.float32)

    def reused():
        for i in range(4):
            buf[:] = i
            yield {"x": buf}

    out = list(device_prefetch(reused(), size=2, device="cpu", staging=True))
    assert [float(b["x"][0]) for b in out] == [0.0, 1.0, 2.0, 3.0]


def test_device_iter_protocol_and_replay():
    batches = [{"x": np.full(2, i, np.float32)} for i in range(4)]
    it = DeviceIter(lambda: iter(batches), size=2, device="cpu",
                    staging=True)
    got = [float(b["x"][0]) for b in it]
    assert got == [0.0, 1.0, 2.0, 3.0]
    assert [float(b["x"][0]) for b in it] == got  # replay


def test_host_staging_reuses_slots_when_copies_do_not_alias():
    pool = HostStaging(slots=2)
    a = {"x": np.arange(64, dtype=np.float32)}
    s1 = pool.stage(a)
    np.testing.assert_array_equal(s1["x"].numpy(), a["x"])
    assert s1["x"].data_ptr() != a["x"].ctypes.data
    pool.release(s1)
    s2 = pool.stage({"x": np.zeros(64, np.float32)})
    assert s2["x"] is s1["x"]  # the fixed-shape steady state
    s3 = pool.stage({"x": np.zeros(8, np.float32)})
    assert s3["x"] is not s1["x"] and s3["x"].shape == (8,)


def test_host_staging_never_reuses_aliased_slots():
    pool = HostStaging(slots=2, alias_unsafe=True)
    a = {"x": np.arange(16, dtype=np.float32)}
    s1 = pool.stage(a)
    pool.release(s1)
    s2 = pool.stage(a)
    assert s2["x"] is not s1["x"]
