"""The object-store slice as a whole, against the JAX package's.

A seeded libsvm corpus is uploaded once to an emulator root both
packages read. The port: ``Pipeline.from_uri("obj://…").parse(format=
"libsvm").batch(pad=True).to_device("cpu")`` (``engine="auto"``, which
takes the golden parse on a remote URI) → 5 SGD steps of
``SparseLinearModel`` → ``ShardedCheckpoint("obj://…")`` save and
restore. The reference: its Parser over the same URI → ``pad_single``
→ 5 ``train_step``s of its JAX model from the same (zero) weights.
Losses and the final weights agree at the tolerance
``tests/test_torch_slice.py`` records (rtol 1e-5, atol 1e-6: CPU fp32 on
both sides, the CSR sums in different orders); the second epoch over
the URI makes no GET, and the restored model equals the trained one bit
for bit."""

import numpy as np
import torch

from dmlc_tpu.data.padding import pad_single as ref_pad_single
from dmlc_tpu.data.parser import Parser as RefParser
from dmlc_tpu.data.rowblock import RowBlockContainer as RefContainer
from dmlc_tpu.models.linear import SparseLinearModel as RefModel
from dmlc_tpu_torch.convert import params_to_numpy
from dmlc_tpu_torch.io.checkpoint import ShardedCheckpoint
from dmlc_tpu_torch.models.linear import SparseLinearModel
from dmlc_tpu_torch.pipeline import Pipeline

RTOL, ATOL = 1e-5, 1e-6  # tests/test_torch_slice.py's
ROWS, FEATURES, ROW_BUCKET, MAX_NNZ = 2000, 4096, 256, 12
NNZ_BUCKET = ROW_BUCKET * MAX_NNZ
STEPS = 5
URI = "obj://bucket/train.libsvm"


def _corpus():
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
    return ("\n".join(lines) + "\n").encode()


def _reference_run():
    c = RefContainer(np.uint32)
    for block in RefParser.create(URI, format="libsvm", engine="auto"):
        c.push_block(block)
    block = c.get_block()
    batches = [ref_pad_single(block.slice(s, min(s + ROW_BUCKET,
                                                 block.size)),
                              ROW_BUCKET, NNZ_BUCKET)
               for s in range(0, block.size, ROW_BUCKET)][:STEPS]
    model = RefModel(FEATURES, learning_rate=2.0)
    params = {k: np.asarray(v) for k, v in model.init_params().items()}
    losses = []
    for batch in batches:
        params, loss = model.train_step(params, dict(batch))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in params.items()}


def test_five_steps_from_obj_match_jax(tmp_path, monkeypatch):
    import dmlc_tpu.io.objstore as ref_objstore
    import dmlc_tpu.io.objstore.fs as ref_ofs
    import dmlc_tpu.io.pagestore as ref_ps
    import dmlc_tpu_torch.io.objstore as objstore
    import dmlc_tpu_torch.io.objstore.fs as ofs
    import dmlc_tpu_torch.io.pagestore as ps
    for name in (ofs.ENV_ROOT, ofs.ENV_ENDPOINT):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(ps, "default_store_dir",
                        lambda: str(tmp_path / "port_pages"))
    monkeypatch.setattr(ref_ps, "default_store_dir",
                        lambda: str(tmp_path / "ref_pages"))
    saved, ref_saved = ofs.options(), ref_ofs.options()
    root = str(tmp_path / "objroot")
    try:
        em = objstore.configure(root=root, block_bytes=1 << 15)
        ref_objstore.configure(root=root, block_bytes=1 << 15)
        em.put("bucket", "train.libsvm", _corpus())
        want_losses, want_params = _reference_run()

        built = (Pipeline.from_uri(URI).parse(format="libsvm")
                 .batch(ROW_BUCKET, pad=True, row_bucket=ROW_BUCKET,
                        nnz_bucket=NNZ_BUCKET)
                 .to_device(device="cpu").build())
        epochs = []
        for _ in range(2):
            em.reset_counters()
            model = SparseLinearModel(FEATURES, learning_rate=2.0,
                                      device="cpu")
            losses = []
            for batch in built:
                if len(losses) < STEPS:
                    assert batch["index"].dtype == torch.uint32
                    losses.append(float(model.train_step(batch)))
            epochs.append((losses, params_to_numpy(model.state_dict()),
                           em.counters()["gets"]))
        built.close()
        assert epochs[0][2] > 0 and epochs[1][2] == 0  # warm: no GET
        for losses, got, _ in epochs:
            np.testing.assert_allclose(losses, want_losses, rtol=RTOL,
                                       atol=ATOL)
            for k in ("w", "b"):
                np.testing.assert_allclose(got[k], want_params[k],
                                           rtol=RTOL, atol=ATOL)
        assert np.abs(epochs[1][1]["w"]).max() > 0

        ck = ShardedCheckpoint("obj://bucket/ck")
        ck.save(STEPS, model.state_dict())
        fresh = SparseLinearModel(FEATURES, learning_rate=2.0,
                                  device="cpu")
        state, _ = ck.restore(like=fresh.state_dict())
        fresh.load_state_dict(state)
        for k, v in model.state_dict().items():
            assert torch.equal(fresh.state_dict()[k], v), k
        ck.save(STEPS + 1, model.state_dict())
        assert ck.last_save_bytes_written == 0
    finally:
        for mod, opts in ((objstore, saved), (ref_objstore, ref_saved)):
            mod.configure(None, block_bytes=opts["block_bytes"])
