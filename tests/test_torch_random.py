"""The port's threefry draws (h2o3_tpu_torch.ops.random) against
jax.random as the JAX package runs it (threefry2x32, partitionable,
32-bit integers): PRNGKey, fold_in, split and uniform give the same
bits for small, 32-bit-edge, wrapped and negative seeds, odd, even and
[N, F] shapes and a 100,001-row draw; a draw over padded rows cut to the
real rows is the unpadded draw; the fused row sample equals
w * (uniform < thr), per class too, with an out-of-range code clamped;
and the estimators' seed rule (-1, 0 or None: a time-based seed). The
threefry kernel is held against the plain version on the card in
test_torch_kernels.py, which imports no JAX."""
import jax
import numpy as np
import pytest
import torch

from h2o3_tpu_torch.ops import kernels
from h2o3_tpu_torch.ops import random as trandom
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

SEEDS = [0, 7, 42, 2 ** 31 - 1, 2 ** 31, 2 ** 32 + 9, 2 ** 40 + 3, -5, -1]


def _key_data(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_and_split_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), trandom.prng_key(seed)
    assert _key_data(jk) == tk
    for d in (0, 1, 17, 7919, 2 ** 31 + 5):
        assert _key_data(jax.random.fold_in(jk, d)) == trandom.fold_in(tk, d)
    for n in (2, 3):
        assert tuple(_key_data(k) for k in jax.random.split(jk, n)) == \
            trandom.split(tk, n)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (2,), (7,), (28,), (5, 7), (64, 28),
                                   (100_001,)],
                         ids=lambda s: "x".join(map(str, s)))
def test_uniform_matches_jax_bits(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = jax.random.uniform(jk, shape)
    got = trandom.uniform(trandom.fold_in(trandom.prng_key(seed), 3), shape,
                          "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


def test_uniform_below_is_the_strict_compare():
    key = trandom.prng_key(11)
    u = trandom.uniform(key, (1000,), "cpu")
    for thr in (0.0, 0.25, float(u[17]), 1.0):
        np.testing.assert_array_equal(
            trandom.uniform_below(key, 1000, thr, "cpu").numpy(),
            (u < thr).numpy())
    assert bool(trandom.uniform_below(key, 1000, 1.0, "cpu").all())


@pytest.mark.parametrize("rows,padded", [(3000, 3008), (1, 8),
                                         (100_001, 100_008)])
def test_padded_draw_cut_to_the_rows_is_the_unpadded_draw(rows, padded):
    """Element i depends on i alone: the JAX package's draw over its
    padded rows, cut to the real rows, is the port's draw."""
    key = trandom.fold_in(trandom.prng_key(7), 5)
    full = trandom.uniform(key, (padded,), "cpu")
    np.testing.assert_array_equal(
        _bits(full[:rows].numpy()),
        _bits(trandom.uniform(key, (rows,), "cpu").numpy()))
    jk = jax.random.fold_in(jax.random.PRNGKey(7), 5)
    np.testing.assert_array_equal(
        _bits(np.asarray(jax.random.uniform(jk, (padded,)))[:rows]),
        _bits(full[:rows].numpy()))


def _row_inputs(rows=5001, K=3, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.0, 2.0, rows).astype(np.float32)
    w[rng.random(rows) < 0.1] = 0.0
    y = rng.integers(0, K, rows).astype(np.int32)
    return torch.as_tensor(w), torch.as_tensor(y)


@pytest.mark.parametrize("rate", [0.0, 0.5, 0.632, 0.8, 1.0])
def test_sample_weights_is_w_times_the_compare(rate):
    w, _y = _row_inputs()
    key = trandom.prng_key(3)
    want = w * (trandom.uniform(key, w.shape, "cpu") < rate).float()
    got = trandom.sample_weights(key, w, rate)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    jk = jax.random.PRNGKey(3)
    jw = w.numpy() * (jax.random.uniform(jk, w.shape) < np.float32(rate))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(jw))


def test_sample_weights_per_class_with_clamped_codes():
    """sample_rate_per_class: each row's rate by its class code; codes
    out of [0, K) (an NA response, whose weight is 0) clamp into the
    range, as the JAX package's clip does, never index from the end."""
    w, y = _row_inputs()
    y[:5] = torch.tensor([-1, 3, 7, -9, 2], dtype=torch.int32)
    w[:4] = 0.0
    rates = torch.tensor([0.3, 0.6, 0.9])
    key = trandom.prng_key(12)
    got = trandom.sample_weights(key, w, y=y, rates=rates)
    yc = np.clip(y.numpy(), 0, 2)
    jw = w.numpy() * (np.asarray(jax.random.uniform(
        jax.random.PRNGKey(12), w.shape)) < rates.numpy()[yc])
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(jw))
    assert float(got[:4].abs().sum()) == 0.0


def test_level_subset_keeps_m_columns_inside_the_mask():
    key = trandom.prng_key(5)
    col_mask = torch.tensor([True, True, False, True, True, True, False])
    mask = trandom.level_subset(key, 2, 16, col_mask, 3)
    assert mask.shape == (16, 7)
    assert bool((mask.sum(dim=1) == 3).all())
    assert not bool(mask[:, ~col_mask].any())
    # more than the mask holds: every column of the mask
    full = trandom.level_subset(key, 2, 16, col_mask, 7)
    assert bool((full == col_mask[None, :]).all())


def test_train_key_takes_the_seed_or_the_clock(monkeypatch):
    assert trandom.train_key(42) == trandom.prng_key(42)
    monkeypatch.setattr(trandom.time, "time", lambda: 1234.5678)
    want = trandom.prng_key(int(1234.5678 * 1e3) % 2 ** 31)
    for seed in (-1, 0, None):
        assert trandom.train_key(seed) == want


def test_a_cuda_device_never_reaches_the_plain_version():
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.threefry_uniform((0, 1), (4,), "cpu")
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.threefry_sample((0, 1), torch.ones(4), 0.5)
    with pytest.raises(ValueError, match="unsupported device"):
        trandom.uniform((0, 1), (4,), "meta")
