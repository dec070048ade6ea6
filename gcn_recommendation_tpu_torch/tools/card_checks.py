"""Checks of the int8 quantizer kernel and of quantized serving on the card.

Counterpart of the JAX package's ``tools/tpu_checks.py``, with its sizes
and limits:

* the quantizer kernel (``csrc/quant_int8.cu``, stochastic rounding) at
  [20480, 64], seed 1: every value within one quantization step of its
  input, mean bias below 5e-4 (stochastic rounding is unbiased), the same
  seed bit-equal, another seed different;
* top-20 retrieval over the int8 table against the f32 one for 1,024
  users: mean overlap above 0.9;
* the masked top-k time of a 1,024-user batch over either table.

It ends with ``ALL CARD CHECKS PASSED`` and raises at the first check that
fails.  ``--device cpu`` runs the kernel's plain version (the same
arithmetic, bit for bit).

    python -m gcn_recommendation_tpu_torch.tools.card_checks
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

N, D = 20480, 64
B, K = 1024, 20


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"card check failed: {what}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.ops.quant import quantize_rows_int8, quantized_topk_scores
    from gcn_recommendation_tpu_torch.ops.topk import masked_topk_scores
    from gcn_recommendation_tpu_torch.utils.timing import cuda_ms, device_line, host_ms

    dev = resolve_device(args.device)
    print(device_line(dev), flush=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)).to(dev)

    q, s = quantize_rows_int8(x, seed=1)
    deq = q.float() * s
    step_err = float(((deq - x).abs() / s.clamp_min(1e-12)).max())
    mean_bias = float((deq - x).mean())
    print(f"max step error: {step_err:.4f} (must be <= 1)")
    print(f"mean bias: {mean_bias:.2e} (stochastic rounding -> ~0)")
    check(step_err <= 1.0 + 1e-3, f"step error {step_err}")
    check(abs(mean_bias) < 5e-4, f"mean bias {mean_bias}")

    q2, _ = quantize_rows_int8(x, seed=1)
    q3, _ = quantize_rows_int8(x, seed=2)
    check(torch.equal(q2, q), "same seed must reproduce")
    check(bool((q3 != q).any()), "different seed must differ")
    frac = float((q3 != q).float().mean())
    print(f"seed determinism ok; {frac:.1%} of values differ across seeds")

    u = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
    filt = torch.full((B, 8), N, dtype=torch.int64, device=dev)
    _, idx_q = quantized_topk_scores(u, q, s, filt, K)
    _, idx_f = masked_topk_scores(u, x, filt, K)
    idx_q, idx_f = idx_q.cpu().numpy(), idx_f.cpu().numpy()
    overlap = float(np.mean([len(set(idx_q[b]) & set(idx_f[b])) / K for b in range(B)]))
    print(f"top-{K} overlap int8 vs f32: {overlap:.3f}")
    check(overlap > 0.9, f"top-{K} overlap {overlap}")

    out = {"device": str(dev), "step_err": step_err, "mean_bias": mean_bias,
           "seed_differ": frac, "overlap": overlap}
    for name, fn in (("int8", lambda: quantized_topk_scores(u, q, s, filt, K)),
                     ("f32", lambda: masked_topk_scores(u, x, filt, K))):
        ms = (cuda_ms(fn, reps=40, windows=3) if dev.type == "cuda"
              else host_ms(fn, reps=1, warmup=0))
        out[f"{name}_ms"] = ms
        print(f"{name} masked top-k: {ms:.3f} ms / {B} users ({B / ms * 1e3:,.0f} QPS)"
              + ("" if dev.type == "cuda" else " (cpu)"))
    print("ALL CARD CHECKS PASSED", flush=True)
    return out


if __name__ == "__main__":
    main()
