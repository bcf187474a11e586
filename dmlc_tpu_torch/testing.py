"""Helpers that hold the port to its JAX reference without importing JAX.

``reference_normal`` recomputes, in numpy, the float32 draws of
``jax.random.normal(jax.random.PRNGKey(seed), shape)``, so a model of
the port can start from the parameters its reference's
``init_params(seed)`` draws (the FM twin under ``examples/torch_port/``
does) and the two train from the same point.
"""

import numpy as np


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def _threefry2x32(k0, k1, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32, 20 rounds (Salmon et al., SC 2011), as JAX keys
    its PRNG."""
    ks = (np.uint32(k0), np.uint32(k1),
          np.uint32(k0) ^ np.uint32(k1) ^ np.uint32(0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _erfinv(x: np.ndarray) -> np.ndarray:
    """float32 inverse error function, Giles' single-precision
    polynomials (the form XLA evaluates)."""
    small = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
             -4.39150654e-06, 0.00021858087, -0.00125372503,
             -0.00417768164, 0.246640727, 1.50140941)
    large = (-0.000200214257, 0.000100950558, 0.00134934322,
             -0.00367342844, 0.00573950773, -0.0076224613,
             0.00943887047, 1.00167406, 2.83297682)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, np.float32(small[0]), np.float32(large[0]))
    for a, b in zip(small[1:], large[1:]):
        p = np.where(lt, np.float32(a), np.float32(b)) + p * w
    return (p * x).astype(np.float32)


def reference_normal(seed: int, shape) -> np.ndarray:
    """The float32 draws of ``jax.random.normal(jax.random.PRNGKey(seed),
    shape)`` (threefry2x32 over the flat index's high and low words,
    the two outputs xor-ed; 23 mantissa bits into [1, 2), shifted onto
    (-1, 1); sqrt(2)·erfinv), to about one float32 ulp."""
    n = int(np.prod(shape))
    iota = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        b0, b1 = _threefry2x32(0, seed, (iota >> np.uint64(32)).astype(
            np.uint32), (iota & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, floats * (np.float32(1.0) - lo) + lo)
    return (np.float32(np.sqrt(2)) * _erfinv(u)).reshape(shape)
