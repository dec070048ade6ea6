"""Training traffic: the window drives ``Trainer.train_step(users, pos,
neg)`` back to back.

The batches are drawn in set-up, on the device, from the seed: the train
rows of one shuffled epoch, ``batch_size`` a step (at most
``feed_steps`` steps, so no two rows of the feed are the same row), and
for each row a uniform negative item that is not among the user's train
items (rejection sampling, the reference's ``main.py:349-363``).  The
window goes through the feed in order and starts again at its head.

Two checks, each of ``CHECKED_STEPS`` steps through the window's own call
and feed, read the same three numbers: the steps' losses, the norm of
each table's first gradient as Adam got it (worked out from its first
moment after that step) and the norm of each table's change after the
steps.

* The start: set-up builds the trainer and drives it through its first
  steps on the feed's first batches; the window then goes on from that
  same trainer.  The reference follows these steps from the seed's own
  tables, with Adam fresh.
* The end: once the window has closed and the memory peak is read, the
  same trainer takes the feed's next batches.  Its tables and Adam's
  state are copied first, and the reference follows the steps from that
  copy: it cannot follow the window's hundreds of steps in the time.
  So a path that only starts after set-up (a captured graph, a cache of
  the batch) is checked too.

``train_examples_per_s`` is the window's steps times the batch over the
window's time, which ends in a device synchronise.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import data, roofline
from benchmark.loads import common
from benchmark.harness import Outcome, Run, memory_peak
from benchmark.reference import lightgcn as ref
from benchmark.trace import DeviceTrace, sync

CHECKED_STEPS = 3
LEAF_FLOOR = 1e-3  # leaves whose reference gradient is under this share of the median's


def sample_negatives(users, pos_keys, num_items, gen):
    """A uniform item for each entry of ``users`` that is not one of the
    user's train items (``pos_keys``: sorted ``user * num_items + item``)."""
    neg = torch.randint(0, num_items, users.shape, generator=gen, device=users.device)
    while True:
        q = users * num_items + neg
        at = torch.searchsorted(pos_keys, q).clamp_max(pos_keys.numel() - 1)
        bad = pos_keys[at] == q
        n_bad = int(bad.sum())
        if not n_bad:
            return neg
        neg[bad] = torch.randint(0, num_items, (n_bad,), generator=gen, device=users.device)


def draw_feed(ds, batch: int, max_steps: int, seed: int, device):
    """(users, pos, neg), each ``[steps, batch]`` int64 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(data.torch_seed(seed, 20))
    tu = torch.as_tensor(ds.train_user, dtype=torch.int64, device=device)
    ti = torch.as_tensor(ds.train_item, dtype=torch.int64, device=device)
    steps = min(max_steps, tu.numel() // batch)
    rows = torch.randperm(tu.numel(), generator=gen, device=device)[: steps * batch]
    users, pos = tu[rows].view(steps, batch), ti[rows].view(steps, batch)
    pos_keys = torch.sort(tu * ds.num_items + ti).values
    return users, pos, sample_negatives(users, pos_keys, ds.num_items, gen)


def program_readings(trainer, feed, initial, half: bool = False):
    """The start: losses of the first steps, the first gradient's norm and
    the change's norm after the steps, by table.  ``half`` feeds the first
    half of each batch only (a planted fault: half of the batch left out)."""
    opt = trainer.optimizer
    beta1 = opt.param_groups[0]["betas"][0]
    keys = trainer.model.trainable_keys
    losses, grad = [], None
    for s in range(CHECKED_STEPS):
        u, p, n = (x[s] for x in feed)
        if half:
            u, p, n = (x[: x.numel() // 2] for x in (u, p, n))
        losses.append(trainer.train_step(u, p, n))
        if grad is None:  # no moment in Adam: the table got no gradient
            grad = {k: float(opt.state[t]["exp_avg"].norm() / (1 - beta1))
                    if "exp_avg" in opt.state.get(t, {}) else 0.0
                    for k, t in ((k, getattr(trainer.model, k)) for k in keys)}
    change = {}
    for k in keys:
        t0 = initial(k)
        change[k] = float((getattr(trainer.model, k).detach() - t0).norm())
        del t0
    return [float(x) for x in losses], grad, change


def table_rows(ds) -> dict:
    return {"user_embedding": ds.num_users, "item_embedding": ds.num_items,
            "brand_embedding": ds.num_brands}


def state_of(trainer, rows: dict):
    """Copies of the trainer's tables and of Adam's first and second
    moments, by table (their logical rows), and the steps Adam has taken."""
    opt = trainer.optimizer
    tabs, m, v, taken = {}, {}, {}, 0
    for k in trainer.model.trainable_keys:
        t = getattr(trainer.model, k)
        st = opt.state.get(t, {})
        tabs[k] = t.detach()[: rows[k]].clone()
        if "exp_avg" in st:
            m[k] = st["exp_avg"][: rows[k]].clone()
            v[k] = st["exp_avg_sq"][: rows[k]].clone()
            taken = max(taken, int(st["step"]))
        else:  # Adam has not stepped this table
            m[k], v[k] = torch.zeros_like(tabs[k]), torch.zeros_like(tabs[k])
    return tabs, m, v, taken


def end_readings(trainer, feed, at: int, rows: dict, half: bool = False):
    """The end: the trainer's state, then ``CHECKED_STEPS`` steps on the
    feed's batches from ``at`` on.  Returns the program's readings (as
    ``program_readings``), the state they started from, and the batches."""
    opt = trainer.optimizer
    beta1 = opt.param_groups[0]["betas"][0]
    keys = trainer.model.trainable_keys
    state = state_of(trainer, rows)
    tabs, m0 = state[0], state[1]
    n_feed = feed[0].shape[0]
    batches = [tuple(x[(at + s) % n_feed] for x in feed) for s in range(CHECKED_STEPS)]
    losses, grad = [], None
    for u, p, n in batches:
        if half:
            u, p, n = (x[: x.numel() // 2] for x in (u, p, n))
        losses.append(trainer.train_step(u, p, n))
        if grad is None:  # Adam's first moment is beta1 m0 + (1 - beta1) g
            grad = {k: float((opt.state[t]["exp_avg"][: rows[k]] - beta1 * m0[k]).norm()
                             / (1 - beta1)) if "exp_avg" in opt.state.get(t, {}) else 0.0
                    for k, t in ((k, getattr(trainer.model, k)) for k in keys)}
    change = {k: float((getattr(trainer.model, k).detach()[: rows[k]] - tabs[k]).norm())
              for k in keys}
    return ([float(x) for x in losses], grad, change), state, batches


def reference_readings(ctx: Run, adj, tabs, batches, adam=None):
    """The reference's readings of ``batches`` from ``tabs`` (and Adam's
    state ``adam``, else fresh)."""
    losses, g1, after = ref.train_steps(adj, tabs, batches, ctx.cfg["n_layers"],
                                        ctx.cfg["learning_rate"], ctx.cfg["weight_decay"],
                                        adam=adam)
    grad = {k: float(v.norm()) for k, v in g1.items()}
    change = {k: float((after[k] - tabs[k]).norm()) for k in tabs}
    return losses, grad, change


def start_reference(ctx: Run, ds, adj, feed):
    batches = [tuple(x[s] for x in feed) for s in range(CHECKED_STEPS)]
    return reference_readings(ctx, adj, common.tables(ctx, ds), batches)


def end_reference(ctx: Run, adj, state, batches):
    tabs, m, v, taken = state
    return reference_readings(ctx, adj, tabs, batches, adam=(m, v, taken))


def checks(start, end) -> dict:
    """The compared numbers of both checks: ``compare``'s, and the same
    with ``end_`` before the name."""
    out = compare(*start)
    out.update({f"end_{k}": v for k, v in compare(*end).items()})
    return out


def compare(prog, refr):
    """The three compared numbers: the worst step's relative loss gap, and
    the worst table's gap of first-gradient norms and of change norms.
    A table whose reference gradient is under ``LEAF_FLOOR`` of the median
    table's moves by round-off alone under Adam: it is left out of the
    change."""
    (pl, pg, pc), (rl, rg, rc) = prog, refr
    loss = max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf for a, b in zip(pl, rl))
    grad, _ = common.worst_leaf_gap(pg, rg)
    med = sorted(rg.values())[len(rg) // 2]
    moved = [k for k in rg if rg[k] >= LEAF_FLOOR * med]
    change, _ = common.worst_leaf_gap(pc, rc, moved)
    return {"loss_gap": loss, "grad_norm_gap": grad, "change_norm_gap": change}


def prepare(ctx: Run, dtype: str = None):
    """Data, tables, the port's trainer and the feed."""
    ds = common.dataset(ctx)
    trainer = common.build_trainer(ctx, ds, common.tables(ctx, ds), dtype)
    common.free(ctx.device)  # the drawn tables were copied into the model
    feed = draw_feed(ds, ctx.cfg["batch_size"], int(ctx.traffic["feed_steps"]), ctx.seed,
                     ctx.device)
    return ds, trainer, feed


def initial_table(ctx: Run, ds):
    return lambda k: common.tables(ctx, ds, keys=(k,))[k]


def run(ctx: Run) -> Outcome:
    cfg, batch = ctx.cfg, ctx.cfg["batch_size"]
    ds, trainer, feed = prepare(ctx)
    prog = program_readings(trainer, feed, initial_table(ctx, ds))
    n_feed = feed[0].shape[0]
    step = CHECKED_STEPS
    for _ in range(int(ctx.traffic["warmup_steps"])):
        trainer.train_step(*(x[step % n_feed] for x in feed))
        step += 1
    sync(ctx.device)

    losses = []
    with DeviceTrace(ctx.trace, ctx.device) as tr:
        t_start = time.perf_counter()
        deadline = t_start + ctx.seconds
        while time.perf_counter() < deadline:
            losses.append(trainer.train_step(*(x[step % n_feed] for x in feed)))
            step += 1
        sync(ctx.device)
        t_end = time.perf_counter()
    window_s = t_end - t_start
    peak = memory_peak(ctx.device)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    ctx.log(f"window: {len(losses)} steps in {window_s:.4f} s; set-up {t_start - ctx.t0:.3f} s")
    end_prog, state, batches = end_readings(trainer, feed, step, table_rows(ds))
    del trainer, losses
    common.free(ctx.device)

    t = time.perf_counter()
    ref.full_precision()
    adj = ref.adjacency(ds, ctx.device)
    numbers = checks((prog, start_reference(ctx, ds, adj, feed)),
                     (end_prog, end_reference(ctx, adj, state, batches)))
    ctx.log(f"reference {time.perf_counter() - t:.2f} s; program losses {prog[0]} "
            f"at the start, {end_prog[0]} at the end")
    n = common.num_nodes(ds)
    work = roofline.train_step(common.nnz(ds), n, cfg["embedding_dim"], cfg["n_layers"], batch)
    steps = step - CHECKED_STEPS - int(ctx.traffic["warmup_steps"])
    return Outcome(
        e2e={"train_examples_per_s": steps * batch / window_s,
             "setup_s": t_start - ctx.t0,
             "peak_mem_gib": peak / 2**30},
        obs={"graph_build_s": sum(ctx.spans.host["graph_build"]), "steps": steps,
             "window_s": window_s, "step_work": (work.ops, work.nbytes), "trace": tr.summary},
        checks={k: (v, common.limit(ctx, k)) for k, v in numbers.items()},
        attempted=steps, failed=failed, memory_peak_bytes=peak)
