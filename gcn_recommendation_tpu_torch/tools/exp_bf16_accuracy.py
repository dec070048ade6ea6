"""Experiment: what bf16 propagation storage costs in recall, on the card.

Counterpart of the JAX package's ``tools/exp_bf16_accuracy.py``: trains
LightGCN on the bench-scale latent-factor graph (50k users / 20k items /
2k brands, degree 28, core 8, seed 42) twice, ``compute_dtype`` float32
and then bfloat16, ``EPOCHS`` epochs each with validation every 5, through
the port's ``Trainer``, and compares best val Recall@20 / NDCG@20 and the
time of a step.  It prints the JAX tool's ``graph:``, per-dtype and
``SUMMARY`` lines, with NDCG@20 and ms a step added to them.

    python -m gcn_recommendation_tpu_torch.tools.exp_bf16_accuracy

A step's ms is the median epoch's host-clock time (each epoch ends in a
copy of its losses to the host) over its steps, the first epoch left out;
``--device cpu`` trains on the CPU and labels its times so.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

EPOCHS = 40


def run(dtype: str, bundle, workdir: str, args, dev) -> dict:
    """Train one dtype; returns best recall, its epoch's NDCG, wall and ms a step."""
    from gcn_recommendation_tpu_torch.config import Config
    from gcn_recommendation_tpu_torch.models import get_model
    from gcn_recommendation_tpu_torch.train.trainer import Trainer

    cfg = Config(
        epochs=args.epochs,
        val_interval=args.val_interval,
        compute_dtype=dtype,
        batch_size=args.batch_size,
        checkpoint_dir=os.path.join(workdir, dtype, "ckpt"),
        results_dir=os.path.join(workdir, dtype, "results"),
    )

    class Recorded(Trainer):
        """The port's trainer, recording each epoch's seconds and each
        validation; its progress lines are left out (the summary says it)."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.epoch_s, self.vals = [], []
            self._print = lambda *a, **k: None

        def run_epoch(self):
            t0 = time.perf_counter()
            out = super().run_epoch()  # ends in a copy of the losses to the host
            self.epoch_s.append(time.perf_counter() - t0)
            return out

        def validate(self):
            r = super().validate()
            self.vals.append((float(r[0]), float(r[1])))
            return r

    model = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                                  device=dev)
    trainer = Recorded(cfg, model, bundle)
    t0 = time.perf_counter()
    _, best_recall = trainer.fit()
    wall = time.perf_counter() - t0
    vals, epoch_s = trainer.vals, trainer.epoch_s
    best = int(np.argmax([v[0] for v in vals])) if vals else None
    ndcg = vals[best][1] if vals else 0.0
    steady = epoch_s[1:] or epoch_s
    ms_step = float(np.median(steady)) * 1e3 / trainer.steps_per_epoch
    cpu = "" if dev.type == "cuda" else " (cpu)"
    print(f"[{dtype}] val curve (epoch: recall@20 / ndcg@20): "
          + "  ".join(f"{(k + 1) * args.val_interval}: {r:.6f} / {n:.6f}"
                      for k, (r, n) in enumerate(vals)), flush=True)
    print(f"[{dtype}] best val recall@20 = {best_recall:.4f}  ndcg@20 = {ndcg:.4f}  "
          f"wall {wall:.0f}s ({args.epochs} epochs)  {ms_step:.2f} ms/step{cpu}", flush=True)
    return dict(dtype=dtype, best_recall=float(best_recall), ndcg=float(ndcg),
                best_epoch=(best + 1) * args.val_interval if vals else None,
                curve=vals, wall_s=wall, ms_per_step=ms_step,
                steps_per_epoch=trainer.steps_per_epoch)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num_users", type=int, default=50_000)
    ap.add_argument("--num_items", type=int, default=20_000)
    ap.add_argument("--num_brands", type=int, default=2_000)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--val_interval", type=int, default=5)
    ap.add_argument("--batch_size", type=int, default=2048)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from gcn_recommendation_tpu_torch.core.device import resolve_device
    from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
    from gcn_recommendation_tpu_torch.utils.timing import device_line

    dev = resolve_device(args.device)
    print(device_line(dev), flush=True)
    bundle = synthetic_bundle(
        num_users=args.num_users,
        num_items=args.num_items,
        num_brands=args.num_brands,
        mean_degree=28.0,
        core=8,
        seed=42,
        style="latent",
    )
    print(f"graph: users={bundle.num_users} items={bundle.num_items} "
          f"train={len(bundle.train)}", flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        r32 = run("float32", bundle, workdir, args, dev)
        r16 = run("bfloat16", bundle, workdir, args, dev)
    a, b = r32["best_recall"], r16["best_recall"]
    gap = max((abs(x[0] - y[0]) for x, y in zip(r32["curve"], r16["curve"])), default=0.0)
    print(f"largest |bf16 - f32| recall@20 over the curve: {gap:.6f}", flush=True)
    print(f"SUMMARY recall@20: f32={a:.4f} bf16={b:.4f} "
          f"delta={(b - a):+.4f} ({(b / max(a, 1e-9) - 1) * 100:+.2f}%)  "
          f"ndcg@20: f32={r32['ndcg']:.4f} bf16={r16['ndcg']:.4f} "
          f"delta={(r16['ndcg'] - r32['ndcg']):+.4f}  "
          f"ms/step: f32={r32['ms_per_step']:.2f} bf16={r16['ms_per_step']:.2f}", flush=True)
    return {"device": str(dev), "float32": r32, "bfloat16": r16, "max_curve_gap": gap}


if __name__ == "__main__":
    main()
