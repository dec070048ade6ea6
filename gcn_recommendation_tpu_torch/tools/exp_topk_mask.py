"""Experiment: seen-item masking strategies for full-catalog top-k.

Counterpart of the JAX package's ``tools/exp_topk_mask.py`` (B = 1024
users, I = 20,000 items, d = 64, k = 20; filter widths F = 8, 32, 128 and
1024, half of each row's slots padded).  It times one evaluation batch
(score product, mask, top-k) with each masking strategy, all exact:

  scatter   one ``scatter_`` of MASK_VALUE into the scores (the port's
            ``ops/topk.py`` default)
  compare   ``seen = any_f(filter == iota)`` over a [B, F, I] bool tensor
  fixup     top-(k+F) of the raw scores, the seen entries of that short
            list masked by comparison, top-k again
  nomask    top-k without a mask

The selection is the plain version's: ``ops/topk.py::_topk`` with
``stable``, the stable descending sort that gives ``lax.top_k``'s tie
order.  The tool also times ``torch.topk`` in its place (``scatter
torch.topk``, ``nomask torch.topk``), the selection serving runs, and
``kernel``: ``stable_masked_topk``, what evaluation runs (on the card the
kernel ``csrc/masked_topk.cu``, masking and selection in one launch; on
the CPU the plain scatter version again).  Before timing, fixup and
compare are checked against scatter (same items, values within rtol
1e-6); compare is skipped from F >= 512 as in the JAX tool (its [B, F, I]
intermediate alone is 21 GB at F = 1024).

``COMPARE_MAX_WORK`` (``ops/topk.py``) is the JAX package's crossover
between compare and scatter on a TPU; this measures it on the card.

    python -m gcn_recommendation_tpu_torch.tools.exp_topk_mask

Times are CUDA-event medians (``utils/timing.py``); ``--device cpu`` runs
the same checks and times on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gcn_recommendation_tpu_torch.ops.topk import (
    MASK_VALUE,
    _topk,
    masked_topk_plain,
    stable_masked_topk,
)

B, I, D, K = 1024, 20_000, 64, 20
FILTERS = (8, 32, 128, 1024)
COMPARE_MAX_F = 128    # compare's exactness check up to here
COMPARE_TIMED_BELOW = 512


def mask_scatter(scores, filt, k, stable=True):
    return masked_topk_plain(scores, filt, k, strategy="scatter", stable=stable)


def mask_compare(scores, filt, k, stable=True):
    return masked_topk_plain(scores, filt, k, strategy="compare", stable=stable)


def mask_fixup(scores, filt, k, stable=True):
    f = filt.shape[1]
    vals, idx = _topk(scores, k + f, stable)
    seen = (idx[:, :, None] == filt[:, None, :]).any(dim=-1)
    vals = vals.masked_fill(seen, MASK_VALUE)
    vals2, order = _topk(vals, k, stable)
    return vals2, idx.gather(1, order)


def nomask(scores, filt, k, stable=True):
    return _topk(scores, k, stable)


def kernel(scores, filt, k, stable=True):
    return stable_masked_topk(scores, filt, k)


STRATEGIES = {"scatter": mask_scatter, "compare": mask_compare, "fixup": mask_fixup,
              "nomask": nomask, "kernel": kernel}


def filter_rows(rng, b: int, n: int, f: int) -> np.ndarray:
    """[b, f] sorted random item ids, the second half of each row padded
    with ``n`` (dropped, never matching), as the JAX tool draws them."""
    filt = np.sort(rng.integers(0, n, (b, f)).astype(np.int64), axis=1)
    filt[:, f // 2:] = n
    return filt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--items", type=int, default=I)
    ap.add_argument("--filters", type=int, nargs="+", default=list(FILTERS))
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.utils.timing import cuda_ms, device_line, host_ms

    dev = resolve_device(args.device)
    print(device_line(dev), flush=True)
    b, n = args.batch, args.items
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.standard_normal((b, D)).astype(np.float32)).to(dev)
    it = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32)).to(dev)
    out = {"device": str(dev), "rows": {}, "items": {}}
    for f in args.filters:
        filt = torch.from_numpy(filter_rows(rng, b, n, f)).to(dev)
        scores = u @ it.T
        ref_v, ref_i = mask_scatter(scores, filt, K)
        out["items"][f] = {"scatter": ref_i.cpu().numpy()}
        for name in ("fixup",) + (("compare",) if f <= COMPARE_MAX_F else ()):
            v, i = STRATEGIES[name](scores, filt, K)
            if not torch.equal(i, ref_i):
                raise RuntimeError(f"{name} at F={f}: items differ from scatter's")
            torch.testing.assert_close(v, ref_v, rtol=1e-6, atol=0.0)
            out["items"][f][name] = i.cpu().numpy()
        del scores
        rows = [(name, fn, True) for name, fn in STRATEGIES.items()]
        rows += [("scatter torch.topk", mask_scatter, False),
                 ("nomask torch.topk", nomask, False)]
        for name, fn, stable in rows:
            if name == "compare" and f >= COMPARE_TIMED_BELOW:
                continue

            def batch(fn=fn, stable=stable):
                return fn(u @ it.T, filt, K, stable)

            if dev.type == "cuda":
                ms = cuda_ms(batch, reps=10, windows=3, warmup=2)
            else:
                ms = host_ms(batch, reps=3, warmup=1)
            out["rows"][(f, name)] = ms
            print(f"F={f:5d} {name:18s} {ms:7.3f} ms/batch ({b / ms * 1e3:,.0f} users/s)"
                  + ("" if dev.type == "cuda" else " (cpu)"), flush=True)
    return out


if __name__ == "__main__":
    main()
