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
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)


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
    _check_quantized_topk_scores(k, width, 40, 500, 64)


@pytest.mark.parametrize("b,i,d", [(40, 301, 50), (1, 77, 64), (1, 301, 50)])
def test_quantized_topk_scores_match_jax_at_odd_shapes(b, i, d):
    """Widths and item counts that are no multiples of 8, one user."""
    _check_quantized_topk_scores(5, 4, b, i, d)


def _check_quantized_topk_scores(k, width, b, i, d):
    rng = np.random.default_rng(k)
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


@pytest.mark.parametrize("b,d", [(1, 64), (8, 64), (40, 50), (1024, 48)])
def test_user_side_quantizer_matches_jax_bitwise(b, d):
    """The kernel's nearest mode, through its plain version: the lines
    ``quantized_topk_scores`` of the JAX package applies to its users
    (jitted there, where ``/ 127.0`` is the multiply by f32(1/127))."""
    import jax

    x = _rows(b, d, b + d)

    @jax.jit
    def jax_user_side(u):
        scale = jnp.maximum(jnp.max(jnp.abs(u), axis=1, keepdims=True), 1e-12) / 127.0
        return jnp.clip(jnp.round(u / scale), -127, 127).astype(jnp.int8), scale

    q_j, s_j = jax_user_side(jnp.asarray(x))
    q, s = quant.quantize_users_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and q.shape == (b, d) and s.shape == (b, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s.numpy().view(np.int32), np.asarray(s_j).view(np.int32))


@pytest.mark.parametrize("fn", ["rows", "users"])
def test_out_buffers_are_written_in_place_with_the_same_bits(fn):
    call = (lambda x, **kw: quant.quantize_rows_int8(x, seed=5, **kw)) if fn == "rows" \
        else quant.quantize_users_int8
    xt = torch.from_numpy(_rows(37, 50, 6))
    q0, s0 = call(xt)
    # strided rows: the corner of a buffer padded for the int8 product
    codes, scales = quant.alloc_user_buffers(37, 50, "cpu")
    assert codes.shape == (37, 56) and not codes.any()
    view = codes[:37, :50]
    q1, s1 = call(xt, out=(view, scales))
    assert q1 is view and s1 is scales and q1.data_ptr() == codes.data_ptr()
    assert torch.equal(q1, q0) and torch.equal(s1, s0)
    assert not codes[:, 50:].any()  # the padding stays zero
    for bad in ((codes[:36, :50], scales), (codes[:37, :50].to(torch.int16), scales),
                (view, scales[:, 0]), (view, scales.double()),
                (torch.zeros((50, 37), dtype=torch.int8).t(), scales)):
        with pytest.raises(ValueError, match="out= wants"):
            call(xt, out=bad)


def test_user_buffers_have_the_int8_products_shape():
    codes, scales = quant.alloc_user_buffers(8, 64, "cpu")
    assert codes.shape == (32, 64) and scales.shape == (8, 1)  # more than 16 rows
    codes, _ = quant.alloc_user_buffers(100, 20, "cpu")
    assert codes.shape == (100, 24) and codes.dtype == torch.int8


def test_int8_table_is_padded_once_not_per_request():
    """301 items of width 20 are no multiples of 8: the table is padded
    when the catalog loads, every request reads that one tensor, and the
    top-k is what the unpadded table gives."""
    from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
    from gcn_recommendation_tpu_torch.serve import Retriever

    b = synthetic_bundle(90, 301, 6, mean_degree=9.0, seed=3)
    assert b.num_items == 301
    gen = torch.Generator().manual_seed(0)
    user_emb = torch.randn((b.num_users, 20), generator=gen)
    item_emb = torch.randn((301, 20), generator=gen)
    r = Retriever(user_emb, item_emb, b, quantize=True)
    assert r.item_q.shape == (304, 24) and r.item_scale.shape == (301, 1)
    item_q, item_scale = quant.quantize_rows_int8(item_emb)
    assert torch.equal(r.item_q[:301, :20], item_q) and not r.item_q[301:].any()
    assert not r.item_q[:, 20:].any()
    assert quant.pad_int8_table(r.item_q) is r.item_q  # nothing left to pad

    users = np.unique(b.train.user_idx)[:9]
    ptr, table = r.item_q.data_ptr(), r.item_q
    first = r.recommend(users, k=10)
    buffers = dict(r._user_buffers)
    second = r.recommend(users, k=10)
    assert r.item_q is table and r.item_q.data_ptr() == ptr
    # the user buffers of the request shape are kept too
    assert list(buffers) == [16] and all(r._user_buffers[k][0] is v[0] for k, v in buffers.items())
    np.testing.assert_array_equal(first[1], second[1])
    np.testing.assert_array_equal(first[0], second[0])
    assert first[1].max() < 301

    # the same request against the unpadded table, with no buffers kept
    filt = r._filter_batch(np.concatenate([users, np.zeros(7, np.int64)]), True)
    u = user_emb[np.concatenate([users, np.zeros(7, np.int64)])]
    v, idx = quant.quantized_topk_scores(u, item_q, item_scale, filt, 10)
    np.testing.assert_array_equal(idx[:9].numpy(), first[1])
    np.testing.assert_array_equal(v[:9].numpy(), first[0])
    # the int8 product of the card, run here on the CPU over the padded operands,
    # equals the int32 matmul of the unpadded ones
    codes, scales = quant.alloc_user_buffers(16, 20, "cpu")
    quant.quantize_users_int8(u, out=(codes[:16, :20], scales))
    assert torch.equal(torch._int_mm(codes, r.item_q.T)[:16, :301],
                       codes[:16, :20].to(torch.int32) @ item_q.to(torch.int32).T)


def test_load_library_builds_once_under_two_threads(monkeypatch, tmp_path):
    """Two threads that reach a first use together: one builds and loads,
    the other waits for it and gets the same library."""
    import threading
    import time

    from gcn_recommendation_tpu_torch.kernels import _build

    builds, loads = [], []

    def slow_build(names):
        builds.append(list(names))
        time.sleep(0.2)
        return 0.2

    class FakeLib:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, name):
            fn = lambda *a: 0  # noqa: E731
            object.__setattr__(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(_build, "library_path", lambda name: str(tmp_path / f"{name}.so"))
    monkeypatch.setattr(_build, "_loaded", {})
    got = []
    threads = [threading.Thread(target=lambda: got.append(_build.load_library("quant_int8")))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert builds == [["quant_int8"]] and len(loads) == 1
    assert len(got) == 8 and all(g is got[0] for g in got)
    lib = got[0]
    for fn in ("quantize_rows_int8_launch", "quantize_rows_int8_launch_v1",
               "quant_int8_empty_launch"):
        assert getattr(lib, fn).restype is _build.ctypes.c_int


def test_quant_variants_still_find_their_lines():
    """Every text edit of tools/exp_quant_call.py still applies to
    csrc/quant_int8.cu (the tool itself runs on the card only)."""
    from gcn_recommendation_tpu_torch.kernels import _build
    from gcn_recommendation_tpu_torch.tools import exp_quant_call
    from gcn_recommendation_tpu_torch.tools.exp_tile_variants import variant_source

    with open(_build.source_path("quant_int8")) as f:
        source = f.read()
    assert exp_quant_call.TIME_ONLY <= set(exp_quant_call.VARIANTS)
    for name, edits in exp_quant_call.VARIANTS.items():
        out = variant_source(source, edits, "csrc/quant_int8.cu")
        assert (out == source) == (name == "base")
    with pytest.raises(ValueError, match="csrc/quant_int8.cu no longer holds"):
        variant_source(source, [("no such line", "")], "csrc/quant_int8.cu")


def test_kernel_route_refuses_other_devices():
    x = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        quant.quantize_rows_int8(x)
    with pytest.raises(ValueError, match="unsupported device"):
        quant.quantize_users_int8(x)

