"""The port's int8 quantizer and quantized top-k against the JAX package.

The Pallas kernel runs in interpret mode, as tests/test_quant.py runs it;
its interpreter PRNG yields zero bits, so it is compared with the port's
shared arithmetic at ``u = 0``.  The CUDA kernel itself is compared with
its plain version on the card (``tests/test_torch_cuda.py`` and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_recommendation_tpu.ops import quant as jquant
from gcn_recommendation_tpu_torch.ops import quant


def _rows(n, d, seed):
    """Rows whose magnitudes span several decades (per-row scales differ)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)) * rng.lognormal(0.0, 2.0, (n, 1))
    x[0] = 0.0  # an all-zero row: the 1e-12 absmax guard
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def interp_case():
    x = _rows(2 * jquant.ROW_BLOCK, 64, 0)
    q, s = jquant.quantize_rows_int8_pallas(jnp.asarray(x), seed=5, interpret=True)
    return x, np.asarray(q), np.asarray(s)


def test_uniform_zero_matches_pallas_interpret_bitwise(interp_case):
    x, q_j, s_j = interp_case
    q, s = quant._quantize_with_uniform(torch.from_numpy(x), 0)
    np.testing.assert_array_equal(q.numpy(), q_j)
    np.testing.assert_array_equal(s.numpy().view(np.int32), s_j.view(np.int32))


def test_pallas_interpret_ragged_block_bitwise():
    x = _rows(jquant.ROW_BLOCK, 32, 1)
    q_j, s_j = jquant.quantize_rows_int8_pallas(jnp.asarray(x), seed=0, interpret=True)
    q, s = quant._quantize_with_uniform(torch.from_numpy(x), 0)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))


@pytest.mark.parametrize("n,d", [(100, 16), (256, 64), (1000, 48)])
def test_nearest_matches_jax_fallback_bitwise(n, d):
    x = _rows(n, d, n + d)
    q_j, s_j = jquant.quantize_rows_int8(jnp.asarray(x), use_pallas=False)
    q, s = quant.quantize_rows_int8(torch.from_numpy(x), use_kernel=False)
    assert q.shape == (n, d) and s.shape == (n, 1) and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(
        s.numpy().view(np.int32), np.asarray(s_j).view(np.int32)
    )


def test_stochastic_codes_are_floor_or_ceil(interp_case):
    x, _, _ = interp_case
    xt = torch.from_numpy(x)
    q, s = quant.quantize_rows_int8(xt, seed=3)
    scaled = xt / s
    lo = torch.floor(scaled).clamp(-127, 127)
    hi = torch.ceil(scaled).clamp(-127, 127)
    qf = q.to(torch.float32)
    assert bool(((qf == lo) | (qf == hi)).all())
    # both directions occur: the rounding is not to nearest
    assert bool((qf != torch.round(scaled)).any())


def test_stochastic_scales_equal_pallas(interp_case):
    x, _, s_j = interp_case
    _, s = quant.quantize_rows_int8(torch.from_numpy(x), seed=11)
    np.testing.assert_array_equal(s.numpy(), s_j)


def test_stochastic_deterministic_per_seed_and_seed_sensitive():
    xt = torch.from_numpy(_rows(300, 64, 2))
    q1, _ = quant.quantize_rows_int8(xt, seed=7)
    q2, _ = quant.quantize_rows_int8(xt, seed=7)
    q3, _ = quant.quantize_rows_int8(xt, seed=8)
    assert torch.equal(q1, q2)
    assert not torch.equal(q1, q3)


def test_stochastic_rounding_is_unbiased():
    rng = np.random.default_rng(4)
    n, d = 1600, 64  # ~1e5 values
    x = rng.uniform(-1.0, 1.0, (n, d)).astype(np.float32)
    x[:, 0] = 1.0  # pin every row's scale to 1/127
    xt = torch.from_numpy(x)
    q, s = quant.quantize_rows_int8(xt, seed=9)
    err = (q.double() * s.double() - xt.double())[:, 1:].flatten()
    # each error is frac-dependent with variance <= step^2 / 4
    sigma = float(s.double().max()) * 0.5 / np.sqrt(err.numel())
    assert abs(float(err.mean())) < 4 * sigma, (float(err.mean()), sigma)


def _triple32_numpy(x):
    x = x.astype(np.uint64)
    m = np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(17)
    x = (x * np.uint64(0xED5AD4BB)) & m
    x ^= x >> np.uint64(11)
    x = (x * np.uint64(0xAC4C1B51)) & m
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x31848BAB)) & m
    x ^= x >> np.uint64(14)
    return x


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5, 2**32 - 1])
def test_random_bits_match_uint64_oracle(seed):
    n, d = 37, 24
    counter = np.arange(n * d, dtype=np.uint64).reshape(n, d)
    key = _triple32_numpy(np.array([seed], np.uint64))[0]
    want = _triple32_numpy(counter ^ key)
    got = quant.random_bits(n, d, seed).numpy().astype(np.uint64)
    np.testing.assert_array_equal(got, want)


def test_mul_u32_wraps_exactly_at_the_top():
    xs = np.array([0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF, 0x80000001], np.uint64)
    for c in (0xFFFFFFFF, 0xED5AD4BB, 0x31848BAB):
        got = quant._mul_u32(torch.from_numpy(xs.astype(np.int64)), c).numpy()
        want = [(int(v) * c) % 2**32 for v in xs]
        assert got.tolist() == want


@pytest.mark.parametrize("k,width", [(5, 4), (20, 16)])
def test_quantized_topk_scores_match_jax(k, width):
    rng = np.random.default_rng(k)
    b, i, d = 40, 500, 64
    u = rng.standard_normal((b, d)).astype(np.float32)
    items = rng.standard_normal((i, d)).astype(np.float32)
    filt = np.full((b, width), i, np.int32)
    filt[:, : width // 2] = rng.integers(0, i, (b, width // 2))
    q_j, s_j = jquant.quantize_rows_int8(jnp.asarray(items), use_pallas=False)
    v_j, i_j = jquant.quantized_topk_scores(
        jnp.asarray(u), q_j, s_j, jnp.asarray(filt), k
    )
    v, idx = quant.quantized_topk_scores(
        torch.from_numpy(u),
        torch.from_numpy(np.array(q_j)),
        torch.from_numpy(np.array(s_j)),
        torch.from_numpy(filt.astype(np.int64)),
        k,
    )
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_j))


def test_kernel_route_refuses_other_devices():
    x = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        quant.quantize_rows_int8(x)

