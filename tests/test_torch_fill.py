"""The port's dead-band detection and linear fill against ``msid_tpu.ops.fill``.

Seeded numpy tiles with killed bands (thermal noise only) and a random
SPD Gram matrix go to both sides; fp32 throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msid_tpu.ops import fill as jfill
from msid_tpu_torch.ops import fill as pfill

torch.set_num_threads(2)

# fp32 solves of a 14x14 system on both sides: 1e-4 absolute.
ATOL = 1e-4
KILLED = ((0, 2), (0, 9), (1, 12), (2, 0), (2, 1))


def tiles(shape=(3, 16, 16, 13), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, shape).astype(np.float32)
    for b, c in KILLED:
        x[b, :, :, c] = rng.normal(0, 0.005, shape[1:3])
    return x


def spd_gram(n=14, seed=1):
    a = np.random.default_rng(seed).normal(0, 1, (n, n))
    return (a @ a.T / n + 0.1 * np.eye(n)).astype(np.float32)


def test_detect_alive():
    x = tiles()
    got = pfill.detect_alive(torch.from_numpy(x)).numpy()
    want = np.array(jfill.detect_alive(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 1, 1, 13)
    assert {(b, c) for b, c in zip(*np.nonzero(got[:, 0, 0] == 0))} == set(KILLED)


def test_fill_weights():
    alive = np.array(jfill.detect_alive(jnp.asarray(tiles())))[:, 0, 0]
    gram = spd_gram()
    got = pfill.fill_weights(torch.from_numpy(gram), torch.from_numpy(alive)).numpy()
    want = np.asarray(jfill.fill_weights(jnp.asarray(gram), jnp.asarray(alive)))
    assert got.shape == (3, 14, 13)
    np.testing.assert_allclose(got, want, atol=ATOL)
    for b, c in KILLED:   # dead inputs never leak into the prediction
        assert np.all(got[b, c] == 0)


@pytest.mark.parametrize("alive_shape", ["b11c", "bc"])
def test_linear_fill(alive_shape):
    x = tiles()
    gram = spd_gram()
    alive = np.array(jfill.detect_alive(jnp.asarray(x)))
    if alive_shape == "bc":
        alive = alive[:, 0, 0]
    got = pfill.linear_fill(torch.from_numpy(x), torch.from_numpy(alive),
                            torch.from_numpy(gram)).numpy()
    want = np.asarray(jfill.linear_fill(jnp.asarray(x), jnp.asarray(alive),
                                        jnp.asarray(gram)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_detect_and_fill():
    x = tiles(seed=3)
    gram = spd_gram(seed=4)
    got, got_alive = pfill.detect_and_fill(torch.from_numpy(x), torch.from_numpy(gram))
    want, want_alive = jfill.detect_and_fill(jnp.asarray(x), jnp.asarray(gram))
    np.testing.assert_array_equal(got_alive.numpy(), np.asarray(want_alive))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # surviving bands pass through untouched; killed ones are replaced
    alive = got_alive.numpy()[:, 0, 0]
    for b in range(x.shape[0]):
        for c in range(x.shape[-1]):
            same = np.array_equal(got.numpy()[b, ..., c], x[b, ..., c])
            assert same == bool(alive[b, c])
