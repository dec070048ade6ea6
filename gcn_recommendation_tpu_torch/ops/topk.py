"""Full-catalog scoring + seen-item masking + top-k.

PyTorch counterpart of ``gcn_recommendation_tpu/ops/topk.py``.  Filter
lists are ``[B, F]`` int64 item ids padded with ``N`` (the catalog size),
which masking drops.

Tie order.  ``lax.top_k`` puts the lower index first among tied scores;
``torch.topk`` promises no order.  Hit and NDCG depend on it, so
evaluation (``topk_eval_batch``) selects with ``stable=True``: the order
(value descending, index ascending), with -0.0 and +0.0 one value.

* ``stable_masked_topk`` — the masked top-k in that order.  On a CUDA
  tensor it launches the hand-written kernel ``csrc/masked_topk.cu``
  (masking and selection in one read of the scores; it launches or
  raises); on a CPU tensor it runs the plain version,
  ``masked_topk_plain``: a ``scatter_`` of MASK_VALUE into a ``[B, N+1]``
  copy, a stable descending sort of each whole row, the first k kept.
  The kernel's values and indices are those of the plain version, bit for
  bit.  It replaces no Pallas kernel: the JAX package leaves the selection
  to ``lax.top_k``.
* ``masked_topk`` — ``stable=True`` goes through ``stable_masked_topk``;
  ``stable=False`` (serving) is ``torch.topk``, whose indices callers
  comparing with the JAX package compare outside tie groups only.

Spans and counter (``utils/profiling.py``): ``topk.select`` around the
selection (the kernel's launch on the card), ``topk.mask`` around the
plain version's masking, ``eval.metrics`` around an evaluation batch's
hit/NDCG; ``topk.kernel_rows`` counts the rows the kernel ranks.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from gcn_recommendation_tpu_torch.utils.profiling import count, span

MASK_VALUE = -1e10  # main.py:424

# The JAX package's crossover between comparison and scatter masking
# (ops/topk.py there, measured on a TPU).  The port only uses it to group
# evaluation users into filter-width tiers, which changes no metric.
COMPARE_MAX_WORK = 64 * 20_000
COMPARE_MAX_F_CAP = 512

# The kernel's limits: k (the winners are ranked against each other, k^2
# comparisons a row), and the dynamic shared memory of one block on sm_90
# (227 KB) less the kernel's static part and a margin.
MAX_K = 1024
KERNEL_SMEM_LIMIT = 227 * 1024 - 2048
_STRATEGIES = ("scatter", "compare")


def compare_max_f(num_items: int) -> int:
    """Filter width of the first evaluation tier at this catalog size."""
    return max(1, min(COMPARE_MAX_F_CAP, COMPARE_MAX_WORK // max(num_items, 1)))


def _topk(x: torch.Tensor, k: int, stable: bool):
    with span("topk.select"):
        if not stable:
            return torch.topk(x, k, dim=1)
        vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k]


def masked_topk_plain(
    scores: torch.Tensor,
    filter_idx: Optional[torch.Tensor],
    k: int,
    *,
    strategy: str = "scatter",
    stable: bool = True,
):
    """The plain PyTorch masked top-k, on any device: ``filter_idx``'s
    entries of ``scores`` [B, N] set to MASK_VALUE (none when it is
    ``None``), then a stable descending sort (``stable``) or ``torch.topk``.

    * ``scatter`` — one ``scatter_`` into a ``[B, N+1]`` copy, so pad
      index N lands in a spare column (``scatter_`` cannot drop it).
    * ``compare`` — ``seen = any_f(filter[b, f] == i)``; materializes a
      ``[B, F, N]`` bool tensor in eager PyTorch (8.7 GB at B=1024,
      F=425, N=20,000).
    """
    b, n = scores.shape
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown masking strategy {strategy!r}")
    if filter_idx is None:
        return _topk(scores, k, stable)
    with span("topk.mask"):
        if strategy == "scatter":
            masked = torch.cat([scores, scores.new_empty((b, 1))], dim=1)
            masked.scatter_(1, filter_idx, MASK_VALUE)
            masked = masked[:, :n]
        else:
            iota = torch.arange(n, dtype=filter_idx.dtype, device=filter_idx.device)
            seen = (filter_idx[:, :, None] == iota[None, None, :]).any(dim=1)
            masked = scores.masked_fill(seen, MASK_VALUE)
    return _topk(masked, k, stable)


def kernel_smem_bytes(n: int, k: int, s: int) -> int:
    """Dynamic shared memory of one block of ``csrc/masked_topk.cu`` at
    ``N = n``, ``k`` and group size ``s`` (``masked_topk_smem_bytes``
    there): the seen bitmap, the group maxima, the top groups, their
    candidates' keys and indices, the winners' keys and indices."""
    groups = -(-n // s)
    top = min(groups, k)
    return 4 * (-(-n // 32) + groups + top + 2 * top * s + 2 * k)


@functools.lru_cache(maxsize=64)
def kernel_plan(n: int, k: int, vec: int) -> Tuple[int, int]:
    """(group size, threads a block) of the kernel at ``N = n`` and ``k``
    with loads of ``vec`` floats (4 or 1).  The group size s is the power
    of two from ``vec`` to ``32 * vec`` that makes the fewest groups plus
    candidates (about sqrt(N / k)), the larger on a tie, among those whose
    shared memory fits a block; raises when none does.  A row of at most
    2,048 items takes 64 threads, a longer one 256.  Memoised: evaluation
    asks for the same few shapes every batch."""
    best = None
    s = vec
    while s <= 32 * vec:
        groups = -(-n // s)
        work = groups + min(groups, k) * s
        if kernel_smem_bytes(n, k, s) <= KERNEL_SMEM_LIMIT and (best is None or work <= best[0]):
            best = (work, s)
        s *= 2
    if best is None:
        raise ValueError(
            f"masked top-k kernel: N = {n} at k = {k} needs more than the "
            f"{KERNEL_SMEM_LIMIT} bytes of shared memory a block may hold")
    return best[1], 256 if n > 2048 else 64


# the bound launcher of csrc/masked_topk.cu and the stream lookup, both set
# at the first launch
_launcher = None
_raw_stream = None


def _bound_launcher():
    global _launcher, _raw_stream
    if _launcher is None:
        from gcn_recommendation_tpu_torch.kernels._build import load_library

        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda index: torch.cuda.current_stream(index).cuda_stream)
        _launcher = load_library("masked_topk").masked_topk_launch
    return _launcher


def _launch_masked_topk(scores: torch.Tensor, filter_idx: Optional[torch.Tensor], k: int):
    """One launch of csrc/masked_topk.cu on ``scores``' device and the
    calling thread's current stream; raises when the kernel cannot take the
    arguments or the launch is refused.  ``k`` above N gives N columns, as
    the sort's slice does."""
    if scores.dtype != torch.float32 or scores.dim() != 2:
        raise ValueError(f"masked top-k kernel takes 2-D float32 scores, got "
                         f"{scores.dtype} {tuple(scores.shape)}")
    b, n = scores.shape
    if filter_idx is not None and (
            filter_idx.dtype != torch.int64 or filter_idx.dim() != 2
            or filter_idx.shape[0] != b or filter_idx.device != scores.device):
        raise ValueError(
            f"masked top-k kernel takes int64 [{b}, F] filter ids on {scores.device}, got "
            f"{filter_idx.dtype} {tuple(filter_idx.shape)} on {filter_idx.device}")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    k = min(int(k), n)
    if k > MAX_K:
        raise ValueError(f"masked top-k kernel takes k up to {MAX_K}, got {k}")
    vals = torch.empty((b, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((b, k), dtype=torch.int64, device=scores.device)
    if b == 0 or k == 0:
        return vals, idx
    scores = scores.contiguous()
    if filter_idx is None:  # no mask: the kernel reads no filter when F is 0
        filter_ptr, f = 0, 0
    else:
        filter_idx = filter_idx.contiguous()
        filter_ptr, f = filter_idx.data_ptr(), filter_idx.shape[1]
    vec = 4 if n % 4 == 0 and scores.data_ptr() % 16 == 0 else 1
    s, threads = kernel_plan(n, k, vec)
    args = (scores.data_ptr(), filter_ptr, b, n, f, k, s, vec, threads, MASK_VALUE,
            vals.data_ptr(), idx.data_ptr())
    fn = _launcher or _bound_launcher()
    index = scores.device.index
    if index == torch.cuda.current_device():
        err = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"masked top-k kernel launch failed: CUDA error {err}")
    stable_masked_topk.launches += 1
    count("topk.kernel_rows", b)
    return vals, idx


def stable_masked_topk(scores: torch.Tensor, filter_idx: Optional[torch.Tensor], k: int):
    """Top-k of ``scores`` [B, N] float32 with each row's ``filter_idx``
    [B, F] int64 entries (padded with N, which is dropped; ``None``: no
    mask) set to MASK_VALUE, in the order (value descending, index
    ascending).  Returns (values [B, k] float32, indices [B, k] int64).  On
    a CUDA tensor one launch of the kernel (it launches or raises); on a
    CPU tensor the plain version, ``masked_topk_plain``."""
    if scores.device.type == "cuda":
        with span("topk.select"):
            return _launch_masked_topk(scores, filter_idx, k)
    if scores.device.type == "cpu":
        return masked_topk_plain(scores, filter_idx, k)
    raise ValueError(f"stable_masked_topk: unsupported device {scores.device}")


# kernel launches since the last reset (the chip smoke test reads it)
stable_masked_topk.launches = 0


def masked_topk(
    scores: torch.Tensor,
    filter_idx: torch.Tensor,
    k: int,
    *,
    strategy: str = "auto",
    stable: bool = False,
):
    """Top-k of ``scores`` [B, N] with each row's ``filter_idx`` entries
    set to MASK_VALUE.  Returns (values [B, k], indices [B, k] int64);
    ``stable`` puts the lower index first among tied scores
    (``stable_masked_topk``: the kernel on the card, where ``strategy``
    changes nothing).  ``strategy`` names the plain version's masking
    (``masked_topk_plain``); ``auto`` picks ``scatter``: the JAX package's
    crossover to ``compare`` was measured on a TPU, and eager PyTorch pays
    the compare mask's memory in full.
    """
    if strategy == "auto":
        strategy = "scatter"
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown masking strategy {strategy!r}")
    if stable and scores.device.type == "cuda":
        return stable_masked_topk(scores, filter_idx, k)
    return masked_topk_plain(scores, filter_idx, k, strategy=strategy, stable=stable)


def masked_topk_scores(
    user_emb_batch: torch.Tensor,  # [B, d]
    item_emb: torch.Tensor,        # [I, d]
    filter_idx: torch.Tensor,      # [B, F] int64, padded with I
    k: int,
    *,
    strategy: str = "auto",
    stable: bool = False,
):
    """Score a user batch against the catalog, mask seen items, top-k."""
    scores = user_emb_batch.float() @ item_emb.float().T
    return masked_topk(scores, filter_idx, k, strategy=strategy, stable=stable)


def topk_hit_metrics(topk_idx: torch.Tensor, true_items: torch.Tensor, valid: torch.Tensor):
    """(recall_sum, ndcg_sum, count) of a top-k index batch against the
    leave-one-out held-out items (main.py:430-438: recall = hit
    indicator, ndcg = 1/log2(pos+2) on a hit), over the ``valid`` rows."""
    hit_matrix = topk_idx == true_items[:, None]
    hit = hit_matrix.any(dim=1)
    pos = hit_matrix.int().argmax(dim=1)
    ndcg = torch.where(
        hit, 1.0 / torch.log2(pos.float() + 2.0), torch.zeros_like(pos, dtype=torch.float32)
    )
    validf = valid.float()
    return (hit.float() * validf).sum(), (ndcg * validf).sum(), validf.sum()


def merge_topk_candidates(all_vals: torch.Tensor, all_idx: torch.Tensor, k: int):
    """Re-select the global top-k from per-shard candidates.

    ``all_vals`` / ``all_idx`` are ``[m, B, k]`` stacks (one slice per item
    shard, global indices); returns ([B, k] values, [B, k] indices).  The
    candidates are flattened shard-major and selected by
    ``stable_masked_topk`` with no mask, so tied scores resolve in
    ``lax.top_k``'s order (earlier shard, then earlier slot, first)."""
    m, b, kk = all_vals.shape
    cand_vals = all_vals.permute(1, 0, 2).reshape(b, m * kk)
    cand_idx = all_idx.permute(1, 0, 2).reshape(b, m * kk)
    best_vals, pos = stable_masked_topk(cand_vals, None, k)
    return best_vals, cand_idx.gather(1, pos)


def topk_eval_batch(user_emb, item_emb, users, true_items, filter_idx, valid, k: int):
    """One evaluation batch: masked top-k of the batch users' scores in
    ``lax.top_k``'s tie order, then its (recall_sum, ndcg_sum, count)."""
    u = user_emb.index_select(0, users)
    _, topk_idx = masked_topk_scores(u, item_emb, filter_idx, k, stable=True)
    with span("eval.metrics"):
        return topk_hit_metrics(topk_idx, true_items, valid)
