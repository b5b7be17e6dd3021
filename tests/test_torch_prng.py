"""The port's threefry stream (``core/prng.py``) against ``jax.random`` on
the CPU, bit for bit.

The JAX package's random policy and random walks run in jax's default
mode, partitionable threefry with 64-bit types off; the port reproduces
that mode and the first test pins it, so a jax with the other default
fails here loudly instead of in a walk.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from jax.extend.random import threefry2x32_p  # noqa: E402

from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels.threefry import ops, ref  # noqa: E402

WORD = st.integers(0, 2**32 - 1)
SEEDS = [0, 1, 7, 2**31 - 1, 2**32 + 5, 123456789]


def _key(seed):
    return np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))


def test_jax_runs_the_partitionable_32_bit_mode():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_enable_x64 is False
    # the mode shows in the bits: split's keys are the hashes of (0, i)
    k = prng.PRNGKey(7)
    np.testing.assert_array_equal(
        prng.split(k).numpy(),
        np.asarray(jax.random.split(jax.random.PRNGKey(7))))


@settings(max_examples=60, deadline=None)
@given(k1=WORD, k2=WORD, xs=st.lists(st.tuples(WORD, WORD), min_size=1,
                                     max_size=9))
def test_threefry2x32_equals_jax(k1, k2, xs):
    x1 = np.array([a for a, _ in xs], dtype=np.uint32)
    x2 = np.array([b for _, b in xs], dtype=np.uint32)
    want = threefry2x32_p.bind(jnp.uint32(k1), jnp.uint32(k2),
                               jnp.asarray(x1), jnp.asarray(x2))
    got = prng.threefry2x32(torch.tensor(k1), torch.tensor(k2),
                            torch.from_numpy(x1.astype(np.int64)),
                            torch.from_numpy(x2.astype(np.int64)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_fold_in_split_equal_jax(seed):
    k, jk = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(k.numpy(), _key(seed))
    for d in (0, 1, 5, 2**31 - 1, 4_000_000_000):
        np.testing.assert_array_equal(prng.fold_in(k, d).numpy(),
                                      np.asarray(jax.random.fold_in(jk, d)))
    for num in (2, 3):
        np.testing.assert_array_equal(
            prng.split(k, num).numpy(), np.asarray(jax.random.split(jk, num)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (1,), (288,), (3, 5)])
def test_uniform_equals_jax(seed, shape):
    k, jk = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    got = prng.uniform(k, shape)
    want = np.asarray(jax.random.uniform(jk, shape))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= 0).all() and (got < 1).all()


def test_split_then_uniform_is_the_random_policys_draw():
    """The engine's per-visit step (``key, sub = split(key)``, then a
    uniform per partition under ``sub``) over a few visits."""
    k, jk = prng.PRNGKey(3), jax.random.PRNGKey(3)
    for _ in range(4):
        k, sub = prng.split(k)
        jk, jsub = jax.random.split(jk)
        np.testing.assert_array_equal(
            prng.uniform(sub, (37,)).numpy(),
            np.asarray(jax.random.uniform(jsub, (37,))))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))


@pytest.mark.parametrize("seed", [0, 11])
def test_batched_keys_and_the_walk_tape_equal_vmapped_jax(seed):
    """``fold_in``/``uniform`` over a batch of keys and ``tape_uniform``
    (one pass) against the reference's vmapped tape draw."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 5000, 40)
    step = rng.integers(0, 64, 40)
    key0 = jax.random.PRNGKey(seed)
    keys = jax.vmap(lambda s, t: jax.random.fold_in(
        jax.random.fold_in(key0, s), t))(jnp.asarray(src, jnp.int32),
                                         jnp.asarray(step, jnp.int32))
    want = np.asarray(jax.vmap(jax.random.uniform)(keys))
    k = prng.PRNGKey(seed)
    s, t = torch.from_numpy(src), torch.from_numpy(step)
    tk = prng.fold_in(prng.fold_in(k.expand(40, 2), s), t)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(keys))
    np.testing.assert_array_equal(prng.uniform(tk).numpy(), want)
    np.testing.assert_array_equal(prng.tape_uniform(k, s, t).numpy(), want)


def test_draw_rejects_bad_arguments():
    k = prng.PRNGKey(0)
    with pytest.raises(ValueError, match="key must be int64"):
        ops.draw(k.to(torch.int32), 4)
    with pytest.raises(ValueError, match="at most two"):
        ops.draw(k, 2, folds=[torch.zeros(2, dtype=torch.int64)] * 3)
    with pytest.raises(ValueError, match="1-d tensor of 3 words"):
        ops.draw(k, 3, x2=torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="shape=\\(\\)"):
        prng.uniform(k.expand(3, 2), (2,))
    # the CPU draws count no launch
    ops.reset_launches()
    ref.draw_ref(k, 3)
    prng.uniform(k, (3,))
    assert ops.LAUNCHES == {"threefry": 0}
