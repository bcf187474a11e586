"""SparseLinearModel of the port against the JAX package's.

Both models start from the same weights (``params_from_jax``) and see the
same padded batch (numpy, from a seed). The loss and one SGD step agree
at rtol=1e-5, atol=1e-6: both compute in fp32 on the CPU, with the CSR
sums in different orders.
"""

import numpy as np
import pytest
import torch

from dmlc_tpu.data.padding import pad_single as ref_pad_single
from dmlc_tpu.data.rowblock import RowBlock as RefRowBlock
from dmlc_tpu.models.linear import SparseLinearModel as RefModel
from dmlc_tpu_torch.convert import params_from_jax, params_to_numpy
from dmlc_tpu_torch.models.common import _weighted_mean, stable_bce_on_logits
from dmlc_tpu_torch.models.linear import SparseLinearModel
from dmlc_tpu_torch.utils.logging import DMLCError

RTOL, ATOL = 1e-5, 1e-6
FEATURES = 300


def _batch(seed, rows=100, row_bucket=128, zero_weight_rows=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(0, 10, rows)
    offset = np.zeros(rows + 1, np.int64)
    offset[1:] = np.cumsum(lens)
    nnz = int(offset[-1])
    index = rng.randint(0, FEATURES, nnz).astype(np.uint32)
    value = rng.rand(nnz).astype(np.float32)
    label = np.where(rng.rand(rows) > 0.5, 1.0, -1.0).astype(np.float32)
    weight = (rng.rand(rows) + 0.5).astype(np.float32)
    weight[:zero_weight_rows] = 0.0
    block = RefRowBlock(offset=offset, label=label, index=index,
                        value=value, weight=weight)
    return dict(ref_pad_single(block, row_bucket, nnz + 17))


def _params(seed):
    if seed is None:  # the models' own zero init
        return {"w": np.zeros(FEATURES, np.float32),
                "b": np.zeros((), np.float32)}
    rng = np.random.RandomState(seed)
    return {"w": (0.3 * rng.randn(FEATURES)).astype(np.float32),
            "b": np.float32(0.2)}


def _models(params, l2, lr=0.5):
    ref = RefModel(FEATURES, l2=l2, learning_rate=lr)
    port = SparseLinearModel(FEATURES, l2=l2, learning_rate=lr, device="cpu")
    port.load_state_dict(params_from_jax(params, device="cpu"))
    return ref, port


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("zero_weight_rows", [0, 30])
@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("init", [None, 11])
def test_loss_matches_jax(init, l2, zero_weight_rows):
    params = _params(init)
    batch = _batch(1, zero_weight_rows=zero_weight_rows)
    ref, port = _models(params, l2)
    want = float(ref.loss(params, batch))
    got = float(port.loss(_tensors(batch)).detach())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("zero_weight_rows", [0, 30])
@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("init", [None, 11])
def test_train_step_matches_jax(init, l2, zero_weight_rows):
    params = _params(init)
    batch = _batch(2, zero_weight_rows=zero_weight_rows)
    ref, port = _models(params, l2)
    new_params, want_loss = ref.train_step(params, batch)
    got_loss = port.train_step(_tensors(batch))
    np.testing.assert_allclose(float(got_loss), float(want_loss),
                               rtol=RTOL, atol=ATOL)
    got = params_to_numpy(port.state_dict())
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k], np.asarray(new_params[k]),
                                   rtol=RTOL, atol=ATOL)


def test_all_padded_batch_is_neutral():
    """wsum == 0 (every row padded): loss 0 and no update, as the
    reference's grad-safe guard gives."""
    batch = _batch(3, zero_weight_rows=100)
    params = _params(11)
    ref, port = _models(params, 0.0)
    new_params, want = ref.train_step(params, batch)
    got = port.train_step(_tensors(batch))
    assert float(got) == float(want) == 0.0
    np.testing.assert_array_equal(params_to_numpy(port.state_dict())["w"],
                                  np.asarray(new_params["w"]))


def test_forward_matches_reference_margins():
    params = _params(5)
    batch = _batch(4)
    ref, port = _models(params, 0.0)
    want = np.asarray(ref.forward(params, batch))
    got = port(_tensors(batch)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_predict_proba_matches_reference():
    params = _params(5)
    batch = _batch(4)
    ref, port = _models(params, 0.0)
    want = np.asarray(ref.predict_proba(params, batch))
    got = port.predict_proba(_tensors(batch)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bce_matches_reference_at_zero_margin():
    """At m == 0 the reference's subgradient is -y, not sigma(0) - y."""
    import jax
    import jax.numpy as jnp
    from dmlc_tpu.models.common import stable_bce_on_logits as ref_bce
    labels = np.array([1.0, -1.0, 0.0, 2.0], np.float32)
    margins = np.array([0.0, 0.0, 1.5, -2.0], np.float32)
    want = jax.grad(lambda m: ref_bce(m, jnp.asarray(labels)).sum())(
        jnp.asarray(margins))
    m = torch.from_numpy(margins).requires_grad_()
    stable_bce_on_logits(m, torch.from_numpy(labels)).sum().backward()
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_weighted_mean_guard():
    assert float(_weighted_mean(torch.tensor(0.0), torch.tensor(0.0))) == 0.0
    assert float(_weighted_mean(torch.tensor(1.0), torch.tensor(0.5))) == 2.0


def test_params_round_trip():
    params = _params(9)
    port = SparseLinearModel(FEATURES, device="cpu")
    port.load_state_dict(params_from_jax(params, device="cpu"))
    back = params_to_numpy(port.state_dict())
    assert sorted(back) == ["b", "w"]
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])
        assert back[k].dtype == np.float32


def test_missing_column_is_named():
    port = SparseLinearModel(FEATURES, device="cpu")
    batch = _tensors(_batch(1))
    del batch["weight"]
    with pytest.raises(DMLCError, match="weight"):
        port.loss(batch)


def test_parameters_live_on_the_requested_device():
    port = SparseLinearModel(FEATURES, device="cpu")
    assert port.w.device.type == "cpu" and port.w.shape == (FEATURES,)
    assert port.b.shape == ()
    assert {n for n, _ in port.named_parameters()} == {"w", "b"}
