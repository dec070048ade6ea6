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
* ``hit_histogram`` — an evaluation batch's top-k reduced to the exact
  histogram of the held-out items' positions: on a CUDA tensor one launch
  of the second kernel of ``csrc/masked_topk.cu``, on a CPU tensor
  ``hit_histogram_plain``.  ``topk_eval_batch`` returns it; the caller
  sums a pass's histograms and forms Recall@k and NDCG@k from the sum
  (``train/evaluate.py``).  ``topk_hit_metrics`` is its float reference.

Spans and counters (``utils/profiling.py``): ``topk.select`` around the
selection (the kernel's launch on the card), ``topk.mask`` around the
plain version's masking, ``eval.metrics`` around an evaluation batch's
hit histogram; ``topk.kernel_rows`` counts the rows the top-k kernel
ranks, ``eval.hist_rows`` the rows the histogram kernel reduces.
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


# the bound launchers of csrc/masked_topk.cu (top-k, hit histogram) and the
# stream lookup, all set at the first launch
_launchers = None
_raw_stream = None


def _bound_launchers():
    global _launchers, _raw_stream
    if _launchers is None:
        from gcn_recommendation_tpu_torch.kernels._build import load_library

        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda index: torch.cuda.current_stream(index).cuda_stream)
        lib = load_library("masked_topk")
        _launchers = (lib.masked_topk_launch, lib.topk_hit_histogram_launch)
    return _launchers


def _launch(which: int, device: torch.device, args, what: str) -> None:
    """Launcher ``which`` of ``_bound_launchers`` on ``device``'s current
    stream; raises when the launch is refused."""
    fn = (_launchers or _bound_launchers())[which]
    index = device.index
    if index == torch.cuda.current_device():
        err = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


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
    _launch(0, scores.device, args, "masked top-k")
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
    indicator, ndcg = 1/log2(pos+2) on a hit), over the ``valid`` rows.
    The float reference of ``hit_histogram``; the multi-rank sharded
    evaluation (``parallel/spmd.py::evaluate_sharded``) still sums it."""
    hit_matrix = topk_idx == true_items[:, None]
    hit = hit_matrix.any(dim=1)
    pos = hit_matrix.int().argmax(dim=1)
    ndcg = torch.where(
        hit, 1.0 / torch.log2(pos.float() + 2.0), torch.zeros_like(pos, dtype=torch.float32)
    )
    validf = valid.float()
    return (hit.float() * validf).sum(), (ndcg * validf).sum(), validf.sum()


def hit_histogram_plain(topk_idx: torch.Tensor, true_items: torch.Tensor, valid: torch.Tensor,
                        k: int) -> torch.Tensor:
    """``hit_histogram`` in plain PyTorch, on any device: ``topk_hit_metrics``'
    hit and position, then one ``bincount``."""
    hit_matrix = topk_idx == true_items[:, None]
    hit = hit_matrix.any(dim=1) & valid
    if topk_idx.shape[1]:
        pos = hit_matrix.int().argmax(dim=1)
    else:  # no column: argmax has nothing to reduce, and nothing hits
        pos = torch.zeros_like(true_items)
    counts = torch.bincount(torch.where(hit, pos, k), minlength=k + 1)
    return torch.cat([counts[:k], valid.sum().reshape(1)]).int()


def _launch_hit_histogram(topk_idx: torch.Tensor, true_items: torch.Tensor,
                          valid: torch.Tensor, k: int) -> torch.Tensor:
    """One launch of csrc/masked_topk.cu's hit histogram on ``topk_idx``'s
    device and the calling thread's current stream; raises when the kernel
    cannot take the arguments or the launch is refused."""
    if topk_idx.dtype != torch.int64 or topk_idx.dim() != 2:
        raise ValueError(f"hit histogram kernel takes 2-D int64 top-k indices, got "
                         f"{topk_idx.dtype} {tuple(topk_idx.shape)}")
    b, width = topk_idx.shape
    for name, t, dtype in (("true_items", true_items, torch.int64), ("valid", valid, torch.bool)):
        if t.dtype != dtype or tuple(t.shape) != (b,) or t.device != topk_idx.device:
            raise ValueError(f"hit histogram kernel takes {name} as {dtype} [{b}] on "
                             f"{topk_idx.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not width <= k <= MAX_K:
        raise ValueError(f"hit histogram kernel takes k up to {MAX_K} and at least the "
                         f"top-k's {width} columns, got {k}")
    hist = torch.empty(k + 1, dtype=torch.int32, device=topk_idx.device)
    topk_idx, true_items, valid = topk_idx.contiguous(), true_items.contiguous(), valid.contiguous()
    args = (topk_idx.data_ptr(), true_items.data_ptr(), valid.data_ptr(), b, width, k,
            hist.data_ptr())
    _launch(1, topk_idx.device, args, "hit histogram")
    hit_histogram.launches += 1
    count("eval.hist_rows", b)
    return hist


def hit_histogram(topk_idx: torch.Tensor, true_items: torch.Tensor, valid: torch.Tensor,
                  k: int) -> torch.Tensor:
    """The held-out items' positions in a top-k index batch ``topk_idx``
    [B, w] int64 (w <= k), as [k + 1] int32 counts: ``hist[p]``, p < k, the
    ``valid`` rows whose ``true_items`` entry first equals column p (a held-out
    item that was masked counts where it stands), ``hist[k]`` the valid
    rows.  Recall@k is ``sum(hist[:k]) / hist[k]``, NDCG@k
    ``sum(hist[p] / log2(p + 2)) / hist[k]``.  On a CUDA tensor one launch of
    the kernel (it launches or raises); on a CPU tensor the plain version,
    ``hit_histogram_plain``."""
    if topk_idx.device.type == "cuda":
        return _launch_hit_histogram(topk_idx, true_items, valid, k)
    if topk_idx.device.type == "cpu":
        return hit_histogram_plain(topk_idx, true_items, valid, k)
    raise ValueError(f"hit_histogram: unsupported device {topk_idx.device}")


# kernel launches since the last reset (tests and the chip smoke test read it)
hit_histogram.launches = 0


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
    ``lax.top_k``'s tie order, then its ``hit_histogram`` ([k + 1] int32)."""
    u = user_emb.index_select(0, users)
    _, topk_idx = masked_topk_scores(u, item_emb, filter_idx, k, stable=True)
    with span("eval.metrics"):
        return hit_histogram(topk_idx, true_items, valid, k)
