"""``dmlc_tpu_torch.testing.reference_normal`` against JAX's own draws:
``jax.random.normal(jax.random.PRNGKey(seed), shape)`` and the factors
the reference's FM and FFM ``init_params(seed)`` start from.

Tolerance: rtol 3e-7 (2.5 float32 ulps; XLA's erfinv and numpy's
evaluate the same polynomial in other orders) with atol 1e-7 for draws
near 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dmlc_tpu.models import SparseFFMModel as RefFFM
from dmlc_tpu.models import SparseFMModel as RefFM
from dmlc_tpu_torch.testing import reference_normal

RTOL, ATOL = 3e-7, 1e-7


@pytest.mark.parametrize("seed", [0, 2, 7, 12345, 2**31 - 1])
@pytest.mark.parametrize("shape", [(3,), (257,), (10, 4), (10, 2, 4),
                                   (1000, 8)])
def test_reference_normal_is_jax_normal(seed, shape):
    got = reference_normal(seed, shape)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        jnp.float32))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ref,dims", [
    (RefFM, dict(num_features=10, num_factors=4)),
    (RefFFM, dict(num_features=10, num_fields=2, num_factors=4))],
    ids=["fm", "ffm"])
def test_the_references_factors(ref, dims):
    model = ref(**dims)
    want = np.asarray(model.init_params(seed=2)["V"])
    got = np.float32(model.init_scale) * reference_normal(2, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
