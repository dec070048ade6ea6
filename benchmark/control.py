"""Readings that the comparison limits are set from, on the card.

    python3 benchmark/control.py --workload books_d64.train --seeds 1,2,3 \\
        --control_seeds 3 --seconds 3 --out control.jsonl

For every seed, the numbers that a run of the cell compares, read from a
sound run of the program (the configuration's float32); on the first
``--control_seeds`` seeds also from the control, the program with its own
lower precision switched on (``compute_dtype`` bfloat16 for the
propagation), and, for training, from the program fed half of each batch
(a planted fault: half of the batch left out, the mean taken over the
rest, in the checked steps).  Training reads both of a run's checks: the
start, then ``--seconds`` of steps after the warm-up (a short window),
then the end.  All from one process: the benchmark's data, the port's graph
build and the reference are made once a seed.  Prints one JSON line a
reading and writes them to ``--out``.  Not run by the benchmark's runs.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTROL_DTYPE = "bfloat16"


def train_readings(ctx, kinds):
    """Both checks of a training run: the start, then ``warmup_steps`` and
    ``--seconds`` of steps, then the end."""
    from benchmark import program
    from benchmark.loads import common, train
    from benchmark.reference import lightgcn as ref

    ds = common.dataset(ctx)
    bundle = program.make_bundle(ds, ctx.cfg["graph"]["use_brand"])
    feed = train.draw_feed(ds, ctx.cfg["batch_size"], int(ctx.traffic["feed_steps"]),
                           ctx.seed, ctx.device)
    ref.full_precision()
    adj = ref.adjacency(ds, ctx.device)
    start_ref = train.start_reference(ctx, ds, adj, feed)
    common.free(ctx.device)
    n_feed = feed[0].shape[0]
    out = {}
    for kind in kinds:
        dtype = CONTROL_DTYPE if kind == "control" else None
        half = kind == "fault_half"
        trainer = common.build_trainer(ctx, ds, common.tables(ctx, ds), dtype, bundle)
        start = train.program_readings(trainer, feed, train.initial_table(ctx, ds), half=half)
        step = train.CHECKED_STEPS
        deadline = None
        while deadline is None or time.perf_counter() < deadline:
            trainer.train_step(*(x[step % n_feed] for x in feed))
            step += 1
            if step == train.CHECKED_STEPS + int(ctx.traffic["warmup_steps"]):
                train.sync(ctx.device)
                deadline = time.perf_counter() + ctx.seconds
        train.sync(ctx.device)
        end, state, batches = train.end_readings(trainer, feed, step, train.table_rows(ds),
                                                 half=half)
        del trainer
        common.free(ctx.device)
        out[kind] = dict(train.checks((start, start_ref),
                                      (end, train.end_reference(ctx, adj, state, batches))),
                         steps=step)
        del state, batches
        common.free(ctx.device)
    return out


def eval_readings(ctx, kinds):
    from benchmark import program
    from benchmark.loads import common, eval as ev

    ds = common.dataset(ctx)
    bundle = program.make_bundle(ds, ctx.cfg["graph"]["use_brand"])
    refr = ev.reference(ctx, ds)
    out = {}
    for kind in kinds:
        dtype = CONTROL_DTYPE if kind == "control" else None
        trainer = common.build_trainer(ctx, ds, common.tables(ctx, ds), dtype, bundle)
        tap = ev.ForwardTap(trainer, ctx.device, timed=False)
        results = [trainer.validate() for _ in range(2)]
        out[kind] = ev.compare(refr, results, *(x.detach() for x in tap.last))
        del trainer, tap
        common.free(ctx.device)
    return out


def serve_readings(ctx, kinds):
    from benchmark import data
    from benchmark.loads import common, serve

    out = {}
    for kind in kinds:
        ds, disp, active = serve.setup(ctx, CONTROL_DTYPE if kind == "control" else None)
        try:
            serve.warm(ctx, disp, active)
            due, sizes = serve.schedule(ctx.traffic, ctx.seconds)
            users = serve.request_users(ctx.traffic, ds, sizes, ctx.seed)
            rng = data.seed_rng(ctx.seed, 33)
            sample = set(rng.choice(len(due), size=min(len(due), int(ctx.traffic["check_requests"])),
                                    replace=False).tolist())
            _, _, pendings, _, missing, _, _ = serve.open_loop(disp, due, users, ctx.cfg["top_k"],
                                                            keep=sample)
        finally:
            disp.stop()
        rank_gap, score_gap = serve.check(ctx, ds, pendings, sorted(sample))
        out[kind] = {"rank_gap": rank_gap, "score_gap": score_gap, "missing": missing,
                     "requests": len(due), "checked": len(sample)}
        del disp
        common.free(ctx.device)
    return out


READERS = {"train": train_readings, "eval": eval_readings, "serve": serve_readings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control_seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0, help="window a reading (serving, training)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    torch.set_num_threads(4)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        _, ctx = harness.setup_context(ROOT, args.workload, seed, args.seconds, False,
                                       args.device, time.perf_counter())
        kinds = ["sound"]
        if i < args.control_seeds:
            kinds += ["control"] + (["fault_half"] if ctx.traffic["load"] == "train" else [])
        t = time.perf_counter()
        for kind, numbers in READERS[ctx.traffic["load"]](ctx, kinds).items():
            line = json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                               "numbers": numbers, "s": round(time.perf_counter() - t, 1)})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
