"""The port's threefry random numbers against ``jax.random``.

``pdmpc_torch.prng`` re-implements threefry-2x32 in partitionable mode on
int64 tensors. Its keys, folds, splits, 32-bit bits, uniforms and
permutations are held bit for bit against ``jax.random`` over seeds, step
indices and shapes (odd sizes included), and the random strategies of
``pdmpc_torch.parallel.graph`` against ``pdmpc_tpu.parallel.graph`` for N
from 1 to 64 (tolerance: none, every bit equal). The Gumbel noise goes
through torch's f32 ``log``, which sits an ulp from XLA:CPU's in some
values: its uniforms are bit-equal, the noise agrees within 1e-6
absolute, and the count of differing values is printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdmpc_torch import prng
from pdmpc_torch.ops.search import rollout_noise
from pdmpc_torch.parallel import graph as tg
from pdmpc_tpu.parallel import graph as jg

# One intra-op thread per process (see tests/test_torch_system.py).
torch.set_num_threads(1)

SEEDS = [0, 1, 7, 0 ^ 0x5EED, 123_456, 2**31 - 1]
DATA = [0, 1, 5, 19, 1000, 2**31 - 1]
SHAPES = [(1,), (2,), (5,), (3, 7), (4, 4), (2, 3, 5), (17, 12)]


def jkey(seed, data):
    return jax.random.fold_in(jax.random.PRNGKey(seed), data)


def tkey(seed, data):
    return prng.fold_in(prng.prng_key(seed), data)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bit_equal(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))
    for data in DATA:
        want = jkey(seed, data)
        got = tkey(seed, data)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for num in (1, 2, 3, 6, 7, 10):
            np.testing.assert_array_equal(
                prng.split(got, num).numpy(),
                np.asarray(jax.random.split(want, num)),
                err_msg=f"data {data}, split {num}")


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_bit_equal(seed):
    for data in DATA[:4]:
        jk, tk = jkey(seed, data), tkey(seed, data)
        for shape in SHAPES:
            np.testing.assert_array_equal(
                prng.random_bits(tk, shape).numpy(),
                np.asarray(jax.random.bits(jk, shape)).astype(np.int64),
                err_msg=f"bits {shape}")
            np.testing.assert_array_equal(
                prng.uniform(tk, shape).numpy(),
                np.asarray(jax.random.uniform(jk, shape)),
                err_msg=f"uniform {shape}")


def test_batched_keys_bit_equal():
    """Per-vehicle keys fold_in(fold_in(PRNGKey(seed), k), i) and their
    per-layer splits, batched over vehicles, as the sampled search draws
    them."""
    rng = np.random.default_rng(0)
    for seed, k in zip(rng.integers(0, 1000, 4), rng.integers(0, 50, 4)):
        want = jax.vmap(lambda i: jax.random.split(
            jax.random.fold_in(jkey(int(seed), int(k)), i), 6))(
            jnp.arange(9))
        step = tkey(int(seed), int(k))
        got = prng.split(prng.fold_in(step[None], torch.arange(9)), 6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", list(range(1, 65)))
def test_permutation_and_random_priorities_bit_equal(n):
    np.testing.assert_array_equal(
        prng.permutation(tkey(11, n), torch.arange(1, n + 1)).numpy(),
        np.asarray(jax.random.permutation(jkey(11, n),
                                          jnp.arange(1, n + 1))))
    for seed, step in ((0, 0), (3, 7), (0 ^ 0x5EED, 19)):
        np.testing.assert_array_equal(
            tg.random_priorities(n, step, seed).numpy(),
            np.asarray(jg.random_priorities(n, jnp.int32(step), seed)))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 20, 33, 64])
def test_random_weights_bit_equal(n):
    rng = np.random.default_rng(n)
    directed = np.triu(rng.random((n, n)) < 0.5, 1)
    weights = jax.jit(jg.random_weights, static_argnums=2)
    for seed, step in ((0, 0), (0, 4), (2**20, 39)):
        got = tg.random_weights(torch.as_tensor(directed), step, seed)
        want = weights(jnp.asarray(directed), jnp.int32(step), seed)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.float32


def test_permutation_ties_keep_order():
    """A permutation is the stable sort by the subkey's 32-bit draws, as
    ``lax.sort_key_val`` sorts: equal keys keep their order."""
    key = prng.prng_key(0)
    x = torch.arange(6)
    sub = prng.split(key)[1]
    bits = prng.random_bits(sub, (6,))
    order = torch.sort(bits, stable=True).indices
    assert torch.equal(prng.permutation(key, x), x[order])
    tied = torch.tensor([5, 3, 5, 3, 5, 3])
    assert torch.sort(tied, stable=True).indices.tolist() == [1, 3, 5, 0, 2, 4]


def test_gumbel_close_to_jax():
    """Uniforms on [tiny, 1) bit-equal; the Gumbel noise within 1e-6
    absolute of ``jax.random.gumbel`` (torch's log against XLA's)."""
    keys_j = jax.vmap(lambda i: jax.random.split(
        jax.random.fold_in(jkey(0, 3), i), 6))(jnp.arange(4))
    keys_t = prng.split(prng.fold_in(tkey(0, 3)[None], torch.arange(4)), 6)
    shape = (256, 12)
    tiny = float(jnp.finfo(jnp.float32).tiny)
    u_j = jax.jit(jax.vmap(jax.vmap(lambda k: jax.random.uniform(
        k, shape, minval=tiny, maxval=1.0))))(keys_j)
    np.testing.assert_array_equal(prng.uniform(keys_t, shape, tiny, 1.0)
                                  .numpy(), np.asarray(u_j))
    want = np.asarray(jax.jit(jax.vmap(jax.vmap(
        lambda k: jax.random.gumbel(k, shape))))(keys_j))
    got = prng.gumbel(keys_t, shape).numpy()
    differ = int((got != want).sum())
    print(f"gumbel: {differ} of {want.size} values differ, at most "
          f"{np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert differ < want.size // 2


def test_rollout_noise_is_the_searchs_draw():
    """``rollout_noise`` draws, for vehicle i at step k, the Gumbel noise
    the reference's sampled search draws from fold_in(fold_in(PRNGKey(
    seed), k), i) split into Hp layer keys (tolerance as above)."""
    seed, k, n, hp, r, trims = 4, 9, 3, 6, 32, 12
    got = rollout_noise(seed, k, n, hp, r, trims, "cpu").numpy()
    for i in range(n):
        keys = jax.random.split(jax.random.fold_in(jkey(seed, k), i), hp)
        want = np.stack([np.asarray(jax.random.gumbel(keys[j], (r, trims)))
                         for j in range(hp)])
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-6)
