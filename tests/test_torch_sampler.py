"""Parity of the port's sampler (repro_torch.serving.sampler and the plain
version of the Gumbel-argmax kernel) against ``jax.random`` and the JAX
package's sampler, on the CPU.

  * bit for bit: threefry2x32, the key of a seed, fold_in, the 32-bit
    partitionable bits and the uniform draw (as uint32 and as f32 bit
    patterns), for seeds 0, 1, 7 and 2^32 - 1, positions 0 to 600 and
    V = 1000 and 151,936;
  * the Gumbel values to atol 2e-6 (f32): both sides take two logs, whose
    last bits differ between XLA and torch;
  * token choice equal to the JAX function wherever the JAX top-two gap of
    z + g exceeds 1e-5 (at most 0.1 % of rows may fall under it);
  * ``seed_from_key`` equal to the JAX session's collapse of a key.
Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from repro.serving import sampler as jsampler
from repro.serving.session import _seed_from_key as j_seed_from_key
from repro_torch.serving import sampler as tsampler

pytestmark = pytest.mark.torch_port

SEEDS = (0, 1, 7, 2**32 - 1)
POSITIONS = np.arange(601)
TINY = float(np.finfo(np.float32).tiny)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models gain nothing from intra-op threads, and the suite runs
    several test processes side by side: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jkeys(seed, positions):
    """fold_in(key(seed), p) for every p, as JAX keys and as raw words."""
    base = jax.random.key(np.uint32(seed))
    keys = jax.vmap(lambda p: jax.random.fold_in(base, p))(
        jnp.asarray(positions, jnp.uint32))
    return keys, np.asarray(jax.random.key_data(keys))


def _tkey(seed, positions):
    return tsampler.fold_in(tsampler.random_key(seed),
                            torch.as_tensor(positions, dtype=torch.int64))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_threefry2x32_equals_jax_bitwise():
    rng = np.random.RandomState(0)
    for _ in range(8):
        k = rng.randint(0, 2**32, size=2, dtype=np.uint64).astype(np.uint32)
        x = rng.randint(0, 2**32, size=(2, 257),
                        dtype=np.uint64).astype(np.uint32)
        out = np.asarray(jprng.threefry_2x32(
            (jnp.uint32(k[0]), jnp.uint32(k[1])),
            jnp.asarray(x.reshape(-1))))
        y0, y1 = tsampler.threefry2x32(
            int(k[0]), int(k[1]), torch.from_numpy(x[0].astype(np.int64)),
            torch.from_numpy(x[1].astype(np.int64)))
        np.testing.assert_array_equal(np.concatenate([_u32(y0), _u32(y1)]),
                                      out)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_equal_jax_bitwise(seed):
    k0, k1 = tsampler.random_key(seed)
    want = np.asarray(jax.random.key_data(jax.random.key(np.uint32(seed))))
    assert [int(k0), int(k1)] == want.tolist()
    _, words = _jkeys(seed, POSITIONS)
    t0, t1 = _tkey(seed, POSITIONS)
    np.testing.assert_array_equal(np.stack([_u32(t0), _u32(t1)], -1), words)


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniforms_equal_jax_bitwise(seed):
    """Every position 0..600 at V = 1000, and two positions at the serving
    model's vocabulary, V = 151,936."""
    for positions, V in ((POSITIONS, 1000), (np.array([0, 600]), 151936)):
        keys, _ = _jkeys(seed, positions)
        tkey = _tkey(seed, positions)
        bits = np.asarray(jax.vmap(
            lambda k: jax.random.bits(k, (V,), jnp.uint32))(keys))
        np.testing.assert_array_equal(
            _u32(tsampler.random_bits32(tkey, V)), bits)
        u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (V,), jnp.float32, minval=TINY, maxval=1.0))(keys))
        tu = tsampler.uniform_tiny_one(tkey, V).numpy()
        np.testing.assert_array_equal(tu.view(np.uint32), u.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_atol_of_jax(seed):
    for positions, V in ((POSITIONS[::3], 1000), (np.array([123]), 151936)):
        keys, _ = _jkeys(seed, positions)
        g = np.asarray(jax.vmap(
            lambda k: jax.random.gumbel(k, (V,), jnp.float32))(keys))
        tg = tsampler.gumbel(_tkey(seed, positions), V).numpy()
        np.testing.assert_allclose(tg, g, atol=2e-6, rtol=0)


def _j_lanes(greedy, temp, seed):
    return {"greedy": jnp.asarray(greedy), "temp": jnp.asarray(temp,
                                                               jnp.float32),
            "seed": jnp.asarray(np.asarray(seed, np.uint32))}


def _t_lanes(greedy, temp, seed):
    return {"greedy": torch.tensor(greedy),
            "temp": torch.tensor(temp, dtype=torch.float32),
            "seed": torch.tensor(np.asarray(seed, np.uint32).astype(np.int64))}


def _gap(logits, positions, temp, seed):
    """JAX's top-two gap of z + g per row (B, T)."""
    B, T, V = logits.shape
    z = logits / np.maximum(np.asarray(temp, np.float32), 1e-6)[:, None, None]
    g = np.stack([np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(jax.random.key(np.uint32(seed[b])),
                           int(positions[b, t])), (V,), jnp.float32))
        for t in range(T)]) for b in range(B)])
    top2 = np.sort(z + g, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("case", ["mixed", "all_sampled", "all_greedy"])
def test_choose_tokens_lanes_equals_jax(case):
    rng = np.random.RandomState(1)
    B, T, V = 3, 5, 1000
    logits = (rng.randn(B, T, V) * 2.0).astype(np.float32)
    positions = rng.randint(0, 601, (B, T)).astype(np.int32)
    greedy = {"mixed": [False, True, False], "all_sampled": [False] * 3,
              "all_greedy": [True] * 3}[case]
    temp = [0.8, 1.0, 1.3]
    seed = [0, 7, 2**32 - 1]
    want = np.asarray(jsampler.choose_tokens_lanes(
        jnp.asarray(logits), jnp.asarray(positions),
        _j_lanes(greedy, temp, seed)))
    got = tsampler.choose_tokens_lanes(
        torch.from_numpy(logits), torch.from_numpy(positions),
        _t_lanes(greedy, temp, seed)).numpy()
    assert got.dtype == np.int32
    clear = (_gap(logits, positions, temp, seed) > 1e-5) \
        | np.asarray(greedy)[:, None]
    assert (~clear).mean() <= 1e-3
    np.testing.assert_array_equal(got[clear], want[clear])


@pytest.mark.parametrize("sample", [False, True])
def test_choose_tokens_equals_jax(sample):
    """The session-constant surface: the port keys on ``seed`` where the
    reference takes ``base_key = key(seed)``."""
    rng = np.random.RandomState(2)
    logits = (rng.randn(2, 4, 500) * 2.0).astype(np.float32)
    positions = rng.randint(0, 300, (2, 4)).astype(np.int32)
    want = np.asarray(jsampler.choose_tokens(
        jnp.asarray(logits), jnp.asarray(positions), sample=sample,
        temperature=0.7, base_key=jax.random.key(np.uint32(11))))
    got = tsampler.choose_tokens(torch.from_numpy(logits),
                                 torch.from_numpy(positions), sample=sample,
                                 temperature=0.7, seed=11).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("make_key", [
    lambda: jax.random.key(np.uint32(5)),
    lambda: jax.random.fold_in(jax.random.key(np.uint32(2**32 - 1)), 9),
    lambda: jax.random.split(jax.random.key(np.uint32(7)))[1],
])
def test_seed_from_key_equals_jax(make_key):
    key = make_key()
    words = np.asarray(jax.random.key_data(key))
    assert tsampler.seed_from_key(words) == j_seed_from_key(key)


def test_plain_gumbel_argmax_leaves_greedy_rows_zero():
    rng = np.random.RandomState(3)
    logits = torch.from_numpy((rng.randn(2, 3, 64) * 2).astype(np.float32))
    pos = torch.from_numpy(rng.randint(0, 50, (2, 3)).astype(np.int32))
    out = tsampler.gumbel_argmax_ref(
        logits, pos, torch.tensor([0.9, 0.9]), torch.tensor([3, 4]),
        torch.tensor([True, False]))
    assert out.dtype == torch.int32 and out.shape == (2, 3)
    assert torch.count_nonzero(out[0]) == 0
