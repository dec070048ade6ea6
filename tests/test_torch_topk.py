"""The port's masked top-k (compare and scatter masking) against JAX.

The first tests draw continuous random normals, so ties do not occur and
indices are compared exactly; values within 1e-6 relative.  The stable
top-k's contract (``stable_masked_topk``: the order value descending,
index ascending, which ``csrc/masked_topk.cu`` reproduces on the card) is
held against ``lax.top_k`` on tie-heavy rows, signed zeros, starved and
all-pad rows, filter widths 1 to 512, k of 1, 20 and 100 and the merge
shape.  One difference is by design: ``lax.top_k`` on the CPU ranks -0.0
below +0.0, and the port (the stable sort, and the kernel after it) holds
them one value, so the reference ranks the scores with -0.0 made +0.0.
The kernel's selection (group maxima, the top groups, the candidates'
radix select) is emulated here in numpy and held against the plain
version, at the kernel plan's group sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_recommendation_tpu.ops import topk as jtopk
from gcn_recommendation_tpu_torch.ops import topk
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)


def _case(b, n, f, seed):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((b, n)).astype(np.float32)
    filt = np.full((b, f), n, np.int32)  # pad = N
    for r in range(b):
        m = rng.integers(0, f + 1)  # 0..F real entries per row
        filt[r, :m] = rng.choice(n, m, replace=False)
    return scores, filt


@pytest.mark.parametrize("strategy", ["compare", "scatter", "auto"])
@pytest.mark.parametrize("f", [4, 96])
def test_masked_topk_matches_jax(strategy, f):
    n, k = 300, 10
    scores, filt = _case(16, n, f, seed=f)
    v_j, i_j = jtopk.masked_topk(
        jnp.asarray(scores), jnp.asarray(filt), k,
        strategy="scatter" if strategy == "auto" else strategy,
    )
    v, i = topk.masked_topk(
        torch.from_numpy(scores), torch.from_numpy(filt.astype(np.int64)), k,
        strategy=strategy,
    )
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=1e-6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    # no filtered item survives
    for r in range(len(filt)):
        assert not set(i[r].tolist()) & set(filt[r].tolist())


def test_masked_topk_scores_matches_jax():
    rng = np.random.default_rng(1)
    u = rng.standard_normal((8, 16)).astype(np.float32)
    items = rng.standard_normal((200, 16)).astype(np.float32)
    _, filt = _case(8, 200, 12, seed=2)
    v_j, i_j = jtopk.masked_topk_scores(jnp.asarray(u), jnp.asarray(items), jnp.asarray(filt), 7)
    v, i = topk.masked_topk_scores(
        torch.from_numpy(u), torch.from_numpy(items), torch.from_numpy(filt.astype(np.int64)), 7
    )
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))


def test_unknown_strategy_raises():
    with pytest.raises(ValueError, match="strategy"):
        topk.masked_topk(torch.zeros((1, 4)), torch.zeros((1, 1), dtype=torch.int64), 1,
                         strategy="fixup")


# ------------------------------------------------ the stable top-k's contract


def _masked_np(scores, filt):
    """``scores`` with each row's ids of ``filt`` inside [0, N) set to
    MASK_VALUE (float32)."""
    out = scores.copy()
    n = scores.shape[1]
    for r in range(len(filt)):
        ids = filt[r][(filt[r] >= 0) & (filt[r] < n)]
        out[r, ids] = np.float32(topk.MASK_VALUE)
    return out


def _lax_reference(masked, k):
    """(values, indices) that the contract asks for: ``lax.top_k`` of the
    masked scores with -0.0 made +0.0, the values read back bit for bit."""
    _, idx = jax.lax.top_k(jnp.asarray(masked + np.float32(0.0)), min(k, masked.shape[1]))
    idx = np.asarray(idx).astype(np.int64)
    return np.take_along_axis(masked, idx, axis=1), idx


def _scores(kind, b, n, rng):
    if kind == "ties":  # seven levels
        return (rng.integers(-3, 4, (b, n)) * 0.5).astype(np.float32)
    if kind == "signed_zeros":
        return rng.choice(np.array([-0.0, 0.0, 1.0, -1.0], np.float32), (b, n))
    return rng.standard_normal((b, n)).astype(np.float32)


def _filter(kind, b, n, f, rng):
    filt = np.full((b, f), n, np.int64)
    for r in range(b):
        if kind == "all_pad" or (kind != "starved" and r == 0):
            continue  # row 0 keeps an all-pad filter row in every case
        m = f if kind == "starved" else int(rng.integers(0, f + 1))
        filt[r, :m] = rng.choice(n, m, replace=False)
        rng.shuffle(filt[r])  # pads anywhere in the row
    return filt


CONTRACT_CASES = [
    # (kind, B, N, F, k)
    ("ties", 8, 300, 32, 20),
    ("ties", 8, 300, 1, 1),
    ("ties", 6, 300, 7, 100),
    ("signed_zeros", 8, 200, 16, 20),
    ("signed_zeros", 4, 200, 64, 100),
    ("continuous", 8, 600, 512, 20),
    ("ties", 4, 600, 512, 100),
    ("starved", 6, 110, 100, 20),     # 10 unmasked items a row: masked items fill the rest
    ("starved", 4, 40, 39, 20),
    ("all_pad", 5, 300, 64, 20),
    ("continuous", 5, 257, 64, 1),
    ("ties", 3, 50, 8, 100),          # k above N: N columns, as the sort's slice
    ("merge", 8, 4, 20, 20),          # merge: B rows, m shards of k candidates
    ("merge", 6, 3, 100, 100),
    ("merge", 5, 8, 1, 1),
]


@pytest.mark.parametrize("kind,b,n,f,k", CONTRACT_CASES,
                         ids=[f"{c[0]}-B{c[1]}-N{c[2]}-F{c[3]}-k{c[4]}" for c in CONTRACT_CASES])
def test_stable_topk_contract_matches_lax_top_k(kind, b, n, f, k):
    rng = np.random.default_rng(b * 1000 + n + f + k)
    launches = topk.stable_masked_topk.launches
    if kind == "merge":
        m, kk = n, f
        vals = (rng.integers(-2, 3, (m, b, kk)) * 0.25).astype(np.float32)
        vals = -np.sort(-vals, axis=2)  # each shard's list descending, as a top-k gives it
        idx = rng.integers(0, 10_000, (m, b, kk)).astype(np.int64)
        v_j, i_j = jtopk.merge_topk_candidates(jnp.asarray(vals), jnp.asarray(idx), k)
        v, i = topk.merge_topk_candidates(torch.from_numpy(vals), torch.from_numpy(idx), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(v.numpy().view(np.uint32), np.asarray(v_j).view(np.uint32))
    else:
        scores = _scores(kind, b, n, rng)
        filt = _filter(kind, b, n, f, rng)
        want_v, want_i = _lax_reference(_masked_np(scores, filt), k)
        got = {
            "masked_topk": topk.masked_topk(torch.from_numpy(scores), torch.from_numpy(filt),
                                            k, stable=True),
            "stable_masked_topk": topk.stable_masked_topk(torch.from_numpy(scores),
                                                          torch.from_numpy(filt), k),
        }
        for name, (v, i) in got.items():
            assert v.dtype == torch.float32 and i.dtype == torch.int64, name
            np.testing.assert_array_equal(i.numpy(), want_i, err_msg=name)
            # bit for bit: a -0.0 keeps its sign, a masked item reads MASK_VALUE
            np.testing.assert_array_equal(v.numpy().view(np.uint32), want_v.view(np.uint32),
                                          err_msg=name)
        if kind == "starved":
            assert (want_v == np.float32(topk.MASK_VALUE)).any(axis=1).all()
    assert topk.stable_masked_topk.launches == launches  # a CPU tensor never launches


# ------------------------------------------------ the kernel's selection, emulated


def _order_key(x):
    """The kernel's order-preserving key (``order_key`` in the CUDA
    source) as uint64: NaN above +inf, -0.0 equal to +0.0."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = np.where(u == 0x80000000, 0, u)
    key = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return np.where(np.isnan(x), 0xFFFFFFFF, key).astype(np.uint64)


def _radix_select(comps, bits, k):
    """The kernel's ``radix_select`` and ``pick_bin`` on distinct ints:
    8 bits a pass from the top (the first pass takes the remainder),
    stopping at the first bin that holds exactly the items still wanted.
    Returns (prefix, mask)."""
    prefix, mask, remaining = 0, 0, k
    shift = bits - ((bits - 1) % 8 + 1)
    while True:
        hist = np.zeros(256, np.int64)
        for c in comps:
            if c & mask == prefix:
                hist[(c >> shift) & 0xFF] += 1
        above = 0
        for b in range(255, -1, -1):
            if above + hist[b] >= remaining:
                break
            above += hist[b]
        remaining -= above
        prefix |= b << shift
        mask |= 0xFF << shift
        if hist[b] == remaining or shift == 0:
            return prefix, mask
        shift -= 8


def _kernel_emulation(scores, filt, k):
    """Indices that ``csrc/masked_topk.cu`` selects: group maxima at the
    plan's group size, the k first groups by (max key, group index), their
    items as candidates, the candidates' radix select, the winners ranked."""
    b, n = scores.shape
    k = min(k, n)
    s, _ = topk.kernel_plan(n, k, 4 if n % 4 == 0 else 1)
    mask_key = int(_order_key(np.float32([topk.MASK_VALUE]))[0])
    groups = -(-n // s)
    gbits, ibits = int(groups - 1).bit_length(), int(n - 1).bit_length()
    out = []
    for r in range(b):
        key = _order_key(scores[r])
        ids = filt[r][(filt[r] >= 0) & (filt[r] < n)]
        key[ids] = mask_key
        padded = np.zeros(groups * s, np.uint64)
        padded[:n] = key
        gmax = [int(g) for g in padded.reshape(groups, s).max(axis=1)]
        if groups > k:
            comps = [(g_key << gbits) | ((1 << gbits) - 1 - g) for g, g_key in enumerate(gmax)]
            prefix, mask = _radix_select(comps, 32 + gbits, k)
            top = [g for g, c in enumerate(comps) if c & mask >= prefix]
            assert len(top) == k
        else:
            top = list(range(groups))
        cand = [e for g in top for e in range(g * s, min(g * s + s, n))]
        comps = [(int(key[e]) << ibits) | ((1 << ibits) - 1 - e) for e in cand]
        prefix, mask = _radix_select(comps, 32 + ibits, k) if len(cand) > k else (0, 0)
        win = [(c, e) for c, e in zip(comps, cand) if c & mask >= prefix]
        assert len(win) == k
        out.append([e for _, e in sorted(win, reverse=True)])
    return np.asarray(out, np.int64)


EMULATION_CASES = [
    # (kind, B, N, F, k): the evaluation's shape and the large catalogs at a
    # few rows, the k limit, ragged groups, vec-1 rows
    ("continuous", 2, 20_000, 64, 20),
    ("ties", 2, 20_000, 512, 20),
    ("continuous", 1, 91_599, 64, 20),
    ("ties", 1, 200_000, 128, 20),
    ("ties", 2, 5_000, 64, 1024),
    ("signed_zeros", 3, 1_001, 32, 100),
    ("starved", 3, 90, 80, 20),
    ("ties", 4, 160, 1, 20),
]


@pytest.mark.parametrize("kind,b,n,f,k", EMULATION_CASES,
                         ids=[f"{c[0]}-B{c[1]}-N{c[2]}-F{c[3]}-k{c[4]}" for c in EMULATION_CASES])
def test_kernel_selection_emulated_matches_plain(kind, b, n, f, k):
    rng = np.random.default_rng(n + k)
    scores = _scores(kind, b, n, rng)
    filt = _filter(kind, b, n, f, rng)
    _, want = topk.masked_topk_plain(torch.from_numpy(scores), torch.from_numpy(filt), k)
    np.testing.assert_array_equal(_kernel_emulation(scores, filt, k), want.numpy())


def test_kernel_plan_sizes_and_limits():
    """Group sizes near sqrt(N / k) within a block's shared memory; past the
    limits the wrapper raises before it touches a card."""
    assert topk.kernel_plan(20_000, 20, 4) == (32, 256)   # 625 groups, 640 candidates
    assert topk.kernel_plan(200_000, 20, 4) == (128, 256)
    assert topk.kernel_plan(91_599, 20, 1) == (32, 256)
    assert topk.kernel_plan(80, 20, 4)[1] == 64
    for n, k, vec in ((20_000, 1024, 4), (200_000, 1024, 4), (91_599, 1024, 1), (7, 3, 1)):
        s, _ = topk.kernel_plan(n, k, vec)
        assert vec <= s <= 32 * vec and s & (s - 1) == 0
        assert topk.kernel_smem_bytes(n, k, s) <= topk.KERNEL_SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        topk.kernel_plan(4_000_000, 20, 4)
    with pytest.raises(ValueError, match="k up to 1024"):
        topk._launch_masked_topk(torch.zeros((2, 2000)), None, 1025)
    with pytest.raises(ValueError, match="2-D float32"):
        topk._launch_masked_topk(torch.zeros((2, 20), dtype=torch.float64), None, 5)
    with pytest.raises(ValueError, match="int64"):
        topk._launch_masked_topk(torch.zeros((2, 20)), torch.zeros((2, 3), dtype=torch.int32), 5)
