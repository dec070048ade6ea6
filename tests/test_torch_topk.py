"""The port's masked top-k (compare and scatter masking) against JAX.

Scores are continuous random normals, so ties do not occur and indices
are compared exactly; values within 1e-6 relative.
"""

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
