"""Experiment: what one ELL bucket's gather-multiply-reduce costs per row, by form.

Counterpart of the JAX package's ``tools/exp_min_width.py``: from a
180,000-row source table (d = 64, under the gather knee), one bucket of
``NB`` destination rows and width ``w`` computes ``sum_j e[idx[:, j]] *
w[:, j]`` in one of these forms:

  fused   one ``[NB, w, d]`` gather, multiplied and summed over ``w``
          (``ops/spmm.py::_bucket_reduce`` above ``COLSUM_MAX_WIDTH``)
  colsum  ``w`` width-1 gathers, each multiplied and added in f32
          (``_bucket_reduce`` up to ``COLSUM_MAX_WIDTH = 4``)
  grp4    colsum in groups of 4 columns, the groups' sums added
  grp2    the same in groups of 2

at width 8 with NB = 2,000,000, then fused and grp4 at widths 16, 32 and
64 with NB = 500,000 (the fused intermediate of NB = 2M at those widths
would not fit).  Each timed call feeds a slice of its output back into the
table, so calls serialize.  It prints ms a call and ns per gathered row
(``NB * w`` rows), which says where colsum stops beating fused on this
card: the port keeps the JAX package's ``COLSUM_MAX_WIDTH = 4``.

    python -m gcn_recommendation_tpu_torch.tools.exp_min_width

Times are CUDA-event medians (``utils/timing.py``); ``--device cpu``
times the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

SRC_ROWS = 180_000   # under the gather knee
NB = 2_000_000       # destination rows of the width-8 bucket
WIDE_NB = 500_000    # destination rows of the wider buckets
DIM = 64


def fused(e, idx, wts):
    return (e[idx] * wts[..., None]).sum(dim=1)


def colsum(e, idx, wts):
    out = None
    for j in range(idx.shape[1]):
        t = e.index_select(0, idx[:, j]) * wts[:, j, None]
        out = t if out is None else out + t
    return out


def colsum_grouped(e, idx, wts, group: int = 4):
    total = None
    for g0 in range(0, idx.shape[1], group):
        acc = colsum(e, idx[:, g0:g0 + group], wts[:, g0:g0 + group])
        total = acc if total is None else total + acc
    return total


def colsum_g2(e, idx, wts):
    return colsum_grouped(e, idx, wts, group=2)


FORMS = {"fused": fused, "colsum": colsum, "grp4": colsum_grouped, "grp2": colsum_g2}


def bucket(rng, w: int, nb: int, src_rows: int, device):
    """(idx [nb, w] int64, wts [nb, w] f32) drawn as the JAX tool draws them."""
    idx = rng.integers(0, src_rows, size=(nb, w), dtype=np.int64)
    wts = rng.standard_normal((nb, w)).astype(np.float32) * 1e-3
    return torch.from_numpy(idx).to(device), torch.from_numpy(wts).to(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src_rows", type=int, default=SRC_ROWS)
    ap.add_argument("--nb", type=int, default=NB)
    ap.add_argument("--wide_nb", type=int, default=WIDE_NB)
    ap.add_argument("--wide_widths", type=int, nargs="*", default=[16, 32, 64])
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    if min(args.nb, args.wide_nb) < args.src_rows:
        ap.error("--nb and --wide_nb must be at least --src_rows (the output feeds the table)")

    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.utils.timing import cuda_windows, device_line, host_windows

    dev = resolve_device(args.device)
    print(device_line(dev), flush=True)
    rng = np.random.default_rng(0)
    emb0 = torch.from_numpy(
        rng.standard_normal((args.src_rows, DIM)).astype(np.float32) * 0.1).to(dev)
    cases = [(8, args.nb, f) for f in ("fused", "colsum", "grp4", "grp2")]
    cases += [(w, args.wide_nb, f) for w in args.wide_widths for f in ("fused", "grp4")]
    rows = []
    for w, nb, form in cases:
        idx, wts = bucket(rng, w, nb, args.src_rows, dev)
        fn = FORMS[form]
        cur = {"e": emb0}

        @torch.no_grad()
        def call():
            out = fn(cur["e"], idx, wts)
            # feed a slice of the output back so calls serialize
            cur["e"] = cur["e"] + 1e-6 * out[: args.src_rows]

        if dev.type == "cuda":
            times = cuda_windows(call, reps=5, windows=3, warmup=1)
        else:
            times = host_windows(call, reps=2, warmup=1)
        ms = float(np.median(times))
        row = dict(width=w, nb=nb, form=form, ms=ms, ns_per_row=ms * 1e6 / (nb * w),
                   spread=max(times) / min(times))
        rows.append(row)
        print(f"width {w:3d} nb={nb / 1e6:.1f}M {form:6s}: {ms:7.2f} ms/iter  "
              f"{row['ns_per_row']:5.2f} ns/gathered-row  (spread {row['spread']:.3f})"
              + ("" if dev.type == "cuda" else " (cpu)"), flush=True)
        del idx, wts, cur
    return {"device": str(dev), "rows": rows}


if __name__ == "__main__":
    main()
