"""megalania_tpu_torch's threefry equals jax.random, bit for bit, for the
draws the engine makes (shapes and per-element bounds included)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from megalania_tpu_torch.utils import threefry as R

SEEDS = [0, 1, 1673551, 2**31 - 1]


def _keys(seed, num):
    return (jax.random.split(jax.random.PRNGKey(seed), num),
            R.split(R.PRNGKey(seed), num))


def _eq(j, t):
    j = np.asarray(j)
    t = t.numpy()
    if j.dtype == np.uint32:
        t = t.astype(np.uint32)
    assert j.shape == t.shape, (j.shape, t.shape)
    np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split(seed):
    _eq(jax.random.PRNGKey(seed), R.PRNGKey(seed))
    jk, tk = _keys(seed, 129)
    _eq(jk, tk)
    for num in (2, 3, 4):
        _eq(jax.vmap(lambda k: jax.random.split(k, num))(jk),
            R.split(tk, num))
    _eq(jax.random.split(jk[5], 2), R.split(tk[5], 2))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_scalar_and_vector(seed):
    jk, tk = _keys(seed, 64)
    for lo, hi in ((0, 2048), (0, 65536), (256, 512), (0, 1), (5, 5)):
        _eq(jax.vmap(lambda k: jax.random.randint(k, (), lo, hi))(jk),
            R.randint(tk, (), lo, hi))
    _eq(jax.vmap(lambda k: jax.random.randint(k, (8,), 0, 20))(jk),
        R.randint(tk, (8,), 0, 20))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_per_element_maxval(seed):
    """Per-chain bounds, as moves.biased_topk_choice (max(count, 1)) and
    the packet-site draw (max(live_count, 1)) use them."""
    jk, tk = _keys(seed, 64)
    mx = np.random.default_rng(seed).integers(-3, 3000, 64).astype(np.int32)
    _eq(jax.vmap(lambda k, m: jax.random.randint(k, (), 0, m))(
        jk, jnp.asarray(mx)), R.randint(tk, (), 0, torch.as_tensor(mx)))
    _eq(jax.vmap(lambda k, m: jax.random.randint(
        k, (8,), 0, jnp.maximum(m, 1)))(jk, jnp.asarray(mx)),
        R.randint(tk, (8,), 0, torch.as_tensor(mx).clamp(min=1)[:, None]))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_float32_bits(seed):
    jk, tk = _keys(seed, 257)
    j = np.asarray(jax.vmap(jax.random.uniform)(jk))
    t = R.uniform(tk)
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(j.view(np.int32), t.numpy().view(np.int32))
    # the comparisons the engine makes, in float32
    for thr in (0.5, 0.125):
        np.testing.assert_array_equal(j < thr, (t < thr).numpy())
