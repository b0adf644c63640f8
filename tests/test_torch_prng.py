"""The port's threefry PRNG (``tfmesos_tpu_torch/ops/prng.py``) against
``jax.random`` 0.9.0 on the CPU, on a hypothesis seed matrix.

The integer functions (``PRNGKey``, ``threefry2x32``, ``fold_in``,
``split``, ``bits``) and ``uniform`` must be BIT-exact.  ``gumbel`` takes
two float32 logarithms, and XLA's CPU ``log`` is not torch's (about one
in seven float32 results differ by an ulp), so its values are held at
2e-6 absolute plus 2 ulps relative (the largest difference measured over
10^5 draws at five seeds was 9.5e-7), and ``categorical`` draws must be
equal wherever the two largest ``logits + gumbel`` are more than 1e-4
apart: each fork must be such a near-tie, and is counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu_torch.ops import prng

SEEDS = st.integers(min_value=-2 ** 31, max_value=2 ** 31 - 1)
WORDS = st.integers(min_value=0, max_value=2 ** 32 - 1)
GUMBEL_ATOL = 2e-6
GUMBEL_RTOL = 2.4e-7
NEAR_TIE = 1e-4
SHAPES = [(7,), (3, 11)]
FEW = settings(max_examples=15, deadline=None, derandomize=True)


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_golden_values():
    k = prng.PRNGKey(0)
    assert k.tolist() == [0, 0]
    assert prng.fold_in(k, 3).tolist() == [2467461003, 3840466878]
    assert prng.split(k).tolist() == [[1797259609, 2579123966],
                                      [928981903, 3453687069]]
    assert prng.bits(k, (5,)).tolist() == [4070199207, 4202968722,
                                           1427181096, 2012915765,
                                           2447653815]
    assert prng.categorical(k, torch.zeros(2, 8192)).tolist() == [1296,
                                                                   3306]


@FEW
@given(seed=SEEDS)
def test_prng_key(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  _np(jax.random.PRNGKey(seed)))


def test_prng_key_refuses_seeds_past_int32():
    with pytest.raises(ValueError, match="int32"):
        prng.PRNGKey(2 ** 31)


@FEW
@given(k1=WORDS, k2=WORDS, count=st.lists(WORDS, min_size=2, max_size=12))
def test_threefry2x32(k1, k2, count):
    """jax's ``threefry_2x32(keypair, count)`` hashes the two halves of an
    even-length count as the two counter words."""
    from jax._src import prng as jprng

    count = count[:len(count) // 2 * 2]
    n = len(count) // 2
    want = jprng.threefry_2x32(
        (jnp.uint32(k1), jnp.uint32(k2)), jnp.asarray(count, jnp.uint32))
    c = torch.tensor(count)
    got = prng.threefry2x32(torch.tensor(k1), torch.tensor(k2), c[:n],
                            c[n:])
    np.testing.assert_array_equal(torch.cat(got).numpy(), _np(want))


@FEW
@given(seed=SEEDS, data=WORDS)
def test_fold_in(seed, data):
    want = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    np.testing.assert_array_equal(
        prng.fold_in(prng.PRNGKey(seed), data).numpy(), _np(want))


@FEW
@given(seed=SEEDS, rids=st.lists(WORDS, min_size=1, max_size=5),
       step=st.integers(min_value=0, max_value=4096))
def test_fold_in_batched_is_the_vmap(seed, rids, step):
    """The batcher's per-row keys: fold_in over a [n] vector of rids,
    then of steps, equals the reference's per-row fold_ins."""
    key = jax.random.PRNGKey(seed)
    want = np.stack([_np(jax.random.fold_in(jax.random.fold_in(key, r),
                                            step + i))
                     for i, r in enumerate(rids)])
    steps = torch.arange(len(rids)) + step
    got = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), torch.tensor(rids)),
                       steps)
    np.testing.assert_array_equal(got.numpy(), want)


@FEW
@given(seed=SEEDS, num=st.integers(min_value=1, max_value=5))
def test_split(seed, num):
    want = jax.random.split(jax.random.PRNGKey(seed), num)
    np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), num).numpy(),
                                  _np(want))


@pytest.mark.parametrize("shape", SHAPES)
@FEW
@given(seed=SEEDS)
def test_bits(shape, seed):
    want = jax.random.bits(jax.random.PRNGKey(seed), shape)
    np.testing.assert_array_equal(prng.bits(prng.PRNGKey(seed), shape).numpy(),
                                  _np(want))


@pytest.mark.parametrize("shape", SHAPES)
@FEW
@given(seed=SEEDS)
def test_uniform(shape, seed):
    key = jax.random.PRNGKey(seed)
    tiny = float(np.finfo(np.float32).tiny)
    for lo, hi in ((0.0, 1.0), (tiny, 1.0), (-2.5, 3.0)):
        want = np.asarray(jax.random.uniform(key, shape, minval=lo,
                                             maxval=hi))
        got = prng.uniform(prng.PRNGKey(seed), shape, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("shape", [(4096,), (8, 512)])
@FEW
@given(seed=SEEDS)
def test_gumbel(shape, seed):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    got = prng.gumbel(prng.PRNGKey(seed), shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=GUMBEL_ATOL,
                               rtol=GUMBEL_RTOL)


def _near_tie(logits, key_np, row_shape):
    """The gap between the two largest ``logits + gumbel`` of one
    draw, with the reference's gumbel."""
    z = np.asarray(logits) + np.asarray(jax.random.gumbel(key_np,
                                                          row_shape))
    top = np.sort(z.reshape(-1))[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("shape", [(97,), (3, 8192)])
def test_categorical(shape):
    """A seed matrix of draws (logit scales 0, 1 and 8): every draw that
    forks from JAX's is a near-tie, and the forks are counted."""
    draws = forks = 0
    for seed in range(-20, 20):
        for scale in (0.0, 1.0, 8.0):
            logits = (np.random.RandomState(seed & 0xFFFF).randn(*shape)
                      * scale).astype(np.float32)
            key = jax.random.PRNGKey(seed * 7919)
            want = np.atleast_1d(np.asarray(jax.random.categorical(
                key, jnp.asarray(logits))))
            got = np.atleast_1d(prng.categorical(
                prng.PRNGKey(seed * 7919), torch.from_numpy(logits)).numpy())
            z = np.atleast_2d(logits + np.asarray(jax.random.gumbel(key,
                                                                    shape)))
            for i in np.flatnonzero(got != want):
                row = np.sort(z[i])
                assert row[-1] - row[-2] < NEAR_TIE, (seed, scale, i)
                forks += 1
            draws += got.size
    assert forks <= draws // 100, f"{forks} forks in {draws} draws"


@FEW
@given(seed=SEEDS)
def test_categorical_batched_keys_are_the_vmap(seed):
    """A key a row (the batcher's draw) equals the reference's vmap of
    categorical over (key, row)."""
    rows, v = 4, 257
    logits = np.random.RandomState(seed & 0xFFFF).randn(rows, v).astype(
        np.float32)
    base = jax.random.PRNGKey(seed)
    keys = jax.vmap(lambda r: jax.random.fold_in(base, r))(jnp.arange(rows))
    want = np.asarray(jax.vmap(jax.random.categorical)(keys,
                                                       jnp.asarray(logits)))
    tkeys = prng.fold_in(prng.PRNGKey(seed), torch.arange(rows))
    got = prng.categorical(tkeys, torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(tkeys.numpy(), _np(keys))
    for i in np.flatnonzero(got != want):
        assert _near_tie(logits[i], keys[i], (v,)) < NEAR_TIE


def test_categorical_refuses_mismatched_keys():
    with pytest.raises(ValueError, match="batch"):
        prng.categorical(prng.split(prng.PRNGKey(0), 3),
                         torch.zeros(2, 8))
    with pytest.raises(TypeError, match="float32"):
        prng.categorical(prng.PRNGKey(0), torch.zeros(8, dtype=torch.bfloat16))
