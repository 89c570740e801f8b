"""The port's Threefry-2x32 draw (ops/prng.py) against the JAX package's PRNG,
on the CPU, bit for bit.

Keys, ``fold_in``, ``split`` and ``uniform`` of the installed JAX (Threefry
under its partitionable rule, with 64-bit integers on as tests/conftest.py
sets them) are held against the port's host functions and the plain PyTorch
version of kernel KP. The kernel itself is held to that plain version on the
card by tests/test_torch_cuda.py and chip_smoke.py. Every comparison is exact:
both sides do the same integer arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gomel_tpu_torch.ops import prng

SEEDS = [0, 7, 2 ** 31 + 5, 2 ** 32 + 3, -1, -12345]
DTYPES = [(torch.float32, jnp.float32), (torch.float64, jnp.float64)]


@pytest.mark.parametrize("key,counter,want", [
    ((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
    ((0xffffffff, 0xffffffff), (0xffffffff, 0xffffffff),
     (0x1cb996fc, 0xbb002be7)),
    ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
     (0xc4923a9c, 0x483df7a0))])
def test_threefry_known_answers(key, counter, want):
    """The Random123 known-answer vectors of Threefry-2x32 with 20 rounds."""
    assert prng.threefry2x32(*key, *counter) == want


def test_jax_draws_with_the_rule_the_port_assumes():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_prngkey(seed):
    k = prng.key(seed)
    assert k.dtype == np.uint32 and k.shape == (2,)
    np.testing.assert_array_equal(k, np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", [2 ** 63, -2 ** 63 - 1, 2 ** 64 + 1])
def test_key_overflow_raises_as_jax_does(seed):
    with pytest.raises(OverflowError):
        jax.random.PRNGKey(seed)
    with pytest.raises(OverflowError):
        prng.key(seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 5, 2 ** 31 + 1, 2 ** 32 - 1])
def test_fold_in_matches_jax(seed, data):
    np.testing.assert_array_equal(
        prng.fold_in(prng.key(seed), data),
        np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                      np.uint32(data))))


def test_fold_in_checks_its_arguments():
    with pytest.raises(ValueError, match="outside"):
        prng.fold_in(prng.key(0), -1)
    with pytest.raises(ValueError, match="outside"):
        prng.fold_in(prng.key(0), 2 ** 32)
    with pytest.raises(ValueError, match="one key"):
        prng.fold_in(prng.split_rows(prng.key(0), 2), 1)
    with pytest.raises(ValueError, match="one key"):
        prng.fold_in(np.zeros(2, np.int64), 1)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 4, 7])
def test_split_rows_match_jax(seed, n):
    """Row r of split(key, n) is the same for every n."""
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
    got = prng.split_rows(prng.key(seed), n)
    assert got.dtype == np.uint32 and got.shape == (n, 2)
    np.testing.assert_array_equal(got, want)
    for r in range(n):
        np.testing.assert_array_equal(prng.split_row(prng.key(seed), r),
                                      want[r])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (1001,), (3, 777)])
@pytest.mark.parametrize("dtype,jdtype", DTYPES)
def test_uniform_plain_matches_jax(seed, shape, dtype, jdtype):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                         jdtype))
    got = prng.uniform_plain(prng.key(seed), shape, dtype)
    assert got.dtype == dtype and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    # on the CPU the wrapper is the plain version
    assert torch.equal(prng.uniform(prng.key(seed), shape, dtype, "cpu"), got)
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0


@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("dtype,jdtype", DTYPES)
def test_row_keys_match_jit_vmap(rows, dtype, jdtype):
    """A table of row keys draws row r from key r, as the JAX package's
    batched decode does under jit(vmap(...))."""
    keys = jax.random.split(jax.random.PRNGKey(3), rows)
    want = np.asarray(jax.jit(jax.vmap(
        lambda k: jax.random.uniform(k, (555,), jdtype)))(keys))
    got = prng.uniform(prng.split_rows(prng.key(3), rows), (555,), dtype,
                       "cpu")
    assert got.shape == (rows, 555)
    np.testing.assert_array_equal(got.numpy(), want)
    two_d = prng.uniform(prng.split_rows(prng.key(3), rows), (5, 111), dtype,
                         "cpu")
    np.testing.assert_array_equal(two_d.numpy().reshape(rows, 555), want)


def test_folded_key_draw_matches_jax():
    """The long-form shard's rule: uniform(fold_in(key, shard), [b, chunk])."""
    for shard in (0, 3, 7):
        want = np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(9), shard), (2, 320),
            jnp.float32))
        got = prng.uniform(prng.fold_in(prng.key(9), shard), (2, 320),
                           device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)


def test_uniform_checks_its_arguments():
    k = prng.key(1)
    assert prng.uniform(k, (0,), device="cpu").shape == (0,)
    assert prng.uniform(k, (), device="cpu").shape == ()
    assert prng.uniform(prng.split_rows(k, 2), (0,),
                        device="cpu").shape == (2, 0)
    with pytest.raises(ValueError, match="2\\^32"):
        prng.uniform(k, (2 ** 32,), device="cpu")
    with pytest.raises(ValueError, match="2\\^32"):
        prng.uniform(k, (2 ** 16, 2 ** 16), device="meta")
    with pytest.raises(ValueError, match="keys"):
        prng.uniform(np.zeros(2, np.int32), (4,), device="cpu")
    with pytest.raises(ValueError, match="keys"):
        prng.uniform(np.zeros((2, 3), np.uint32), (4,), device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        prng.uniform(k, (4,), torch.float16, device="cpu")
    # a device that is neither the CPU nor CUDA gets no plain fallback
    with pytest.raises(ValueError, match="neither"):
        prng.uniform(k, (4,), device="meta")


def test_uniform_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        prng.uniform(prng.key(1), (4,), device="cuda")
    assert prng.KERNEL.launches == 0


def test_uniform_defaults_to_the_card():
    """Like jax.random.uniform, the draw goes to the accelerator unless the
    caller names another device; without a card that is a clear error from
    the port's own check, which names the CPU's spelling, not one from
    inside torch's CUDA calls."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        prng.uniform(prng.key(1), (4,))
    with pytest.raises(RuntimeError, match="uniform: device 'cuda'"):
        prng.uniform(prng.split_rows(prng.key(1), 2), (3,), torch.float32)
    assert prng.KERNEL.launches == 0
