"""The port's experiment grids against the JAX package's committed ones.

Counterpart of the JAX package's ``tools/regime_comparison.py``, without
pandas: ``read_runs`` (best / final Recall@20 and NDCG@20 of every
``<exp_dir>/results/<code>/*_epoch_history.csv``, the best epoch, and the
curve shape by the same thresholds), ``orderings``, ``duplicate_spread``,
``fmt_table`` and ``fmt_orderings`` compute what the JAX tool computes.

Where the JAX tool compared its grids with the reference's, this one
compares two grid directories of the same regime: the port's
(``exp_torch_synth*/``, written by ``tools/run_regime_grids.py``) against
the JAX package's committed grid (``exp_synth*/``).  For each regime it
prints one markdown table with, per code, the JAX best R@20 (epoch), the
port's and the difference, both best N@20, both curve shapes and whether
the code holds; then the variant orderings side by side (``fmt_orderings``,
the port as "this framework", JAX as "reference"), the band, and the
port's runs with their final values (``fmt_table``).

**The band** of a regime is ``max(0.003, S)``, ``S`` the larger of the
two grids' duplicate-run spreads (``lase_*`` against ``base_*``).  A code
holds when its best R@20 and best N@20 lie within the band of the JAX
code's and its curve-shape label is the same; an ordering holds when the
port's delta has the JAX sign wherever the JAX delta lies outside the band.

A code that misses is rerun at a second training seed into
``<port grid>/seed<N>/results/<code>/`` (``tools/grid_lanes.sh`` with
``SEED``); the JAX package's own runs of such a code at another seed (its
``tools/run_experiments.py`` on the CPU) go to
``<port grid>/jax_cpu_seed<N>/results/<code>/``, judged by the same rule
with the roles swapped (``jax_seed_rows``).  The table of second seeds
gives, for each metric the code missed, the JAX value beside both of the
port's; the miss is seed variance when the port's two values straddle the
JAX one (for the shape: when one of the two seeds has the JAX label).

    python -m gcn_recommendation_tpu_torch.tools.regime_comparison [--port_root DIR]
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import sys
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the port's grid dir, the JAX package's committed grid of the same regime
REGIME_MAP = [
    ("exp_torch_synth_dense", "exp_synth_dense", "dense catalog (R@20 ~0.66 band)"),
    ("exp_torch_synth", "exp_synth", "sparse books (R@20 ~0.09 band)"),
    ("exp_torch_synth_sport", "exp_synth_sport", "sparse sport (Fusion ~0.05 band)"),
    ("exp_torch_synth_zno", "exp_synth_zno", "weak signal (R@20 ~0.06 band)"),
]
MIN_BAND = 3e-3
ORDERING_KEYS = ["brand_delta", "emb_uplift", "fus_vs_emb", "fus_uplift"]
ORDERING_NAMES = {
    "brand_delta": "brand vs no-brand (best R@20 delta)",
    "emb_uplift": "pretrained-emb init vs base",
    "fus_vs_emb": "Fusion vs emb-init",
    "fus_uplift": "Fusion vs base",
}


def curve_shape(best_epoch: int, last_epoch: int, best_r: float, final_r: float) -> str:
    """Where the best sits and whether the curve holds it."""
    pos = best_epoch / max(1, last_epoch)
    hold = final_r / best_r if best_r > 0 else 1.0
    if hold < 0.8:
        return "peak-then-collapse"
    if pos >= 0.6:
        return "late-climb"
    if pos <= 0.25:
        return "early-plateau"
    return "mid-plateau"


def read_runs(exp_dir: str) -> List[Dict]:
    """One dict per run (``code``, ``best_recall``, ``best_ndcg``,
    ``best_epoch``, ``final_recall``, ``final_ndcg``, ``shape``), in code
    order.  The best row is the first of the highest recall."""
    rows = []
    for path in sorted(glob.glob(os.path.join(exp_dir, "results", "*", "*_epoch_history.csv"))):
        code = os.path.basename(os.path.dirname(path))
        try:
            with open(path, newline="") as f:
                hist = list(csv.DictReader(f))
        except OSError:
            continue
        if not hist or "recall" not in hist[0]:
            continue
        recall = [float(r["recall"]) for r in hist]
        b = recall.index(max(recall))
        best, final = hist[b], hist[-1]
        best_r, final_r = recall[b], recall[-1]
        rows.append(dict(
            code=code,
            best_recall=best_r,
            best_ndcg=float(best["ndcg"]),
            best_epoch=int(best["epoch"]),
            final_recall=final_r,
            final_ndcg=float(final["ndcg"]),
            shape=curve_shape(int(best["epoch"]), int(final["epoch"]), best_r, final_r),
        ))
    return rows


def _suffix(code: str) -> str:
    """``base_150e20c_nob_emb`` -> ``nob_emb`` (strip grid tag + budget)."""
    parts = code.split("_")
    return "_".join(parts[2:]) if len(parts) > 2 else code


def _tag(code: str) -> str:
    return code.split("_", 1)[0]


def orderings(runs: List[Dict]) -> Dict[str, float]:
    """The variant relations of the ``base_*`` codes (best R@20 deltas)."""
    base = {_suffix(r["code"]): r["best_recall"] for r in runs if _tag(r["code"]) == "base"}
    out = {}
    if "brd" in base and "nob" in base:
        out["brand_delta"] = base["brd"] - base["nob"]
    if "nob_emb" in base and "nob" in base:
        out["emb_uplift"] = base["nob_emb"] - base["nob"]
    if "nob_fus" in base and "nob_emb" in base:
        out["fus_vs_emb"] = base["nob_fus"] - base["nob_emb"]
    if "nob_fus" in base and "nob" in base:
        out["fus_uplift"] = base["nob_fus"] - base["nob"]
    return out


def duplicate_spread(runs: List[Dict]) -> float:
    """The run-to-run band of a grid: the largest |lase - base| best R@20
    over the duplicate-config pairs (``brd``, ``nob``); 0.0 without one."""
    best = {(_tag(r["code"]), _suffix(r["code"])): r["best_recall"] for r in runs}
    spreads = [abs(best[("lase", s)] - best[("base", s)])
               for s in ("brd", "nob") if ("lase", s) in best and ("base", s) in best]
    return max(spreads) if spreads else 0.0


def fmt_table(runs: List[Dict], ref_suffixes=None) -> str:
    """The JAX tool's per-grid table (a dagger marks codes absent from
    ``ref_suffixes``)."""
    if not runs:
        return "_(no runs found)_\n"
    lines = [
        "| code | best R@20 (ep) | best N@20 | final R / N | curve shape |",
        "|---|---|---|---|---|",
    ]
    dagger = False
    for r in sorted(runs, key=lambda r: r["code"]):
        mark = ""
        if ref_suffixes is not None and (_tag(r["code"]), _suffix(r["code"])) not in ref_suffixes:
            mark, dagger = " †", True
        lines.append(
            f"| `{r['code']}`{mark} | {r['best_recall']:.4f} (ep{r['best_epoch']}) | "
            f"{r['best_ndcg']:.4f} | {r['final_recall']:.4f} / {r['final_ndcg']:.4f} | "
            f"{r['shape']} |"
        )
    text = "\n".join(lines) + "\n"
    if dagger:
        text += (
            "\n† framework-added run with no same-code reference "
            "counterpart (duplicate-config rerun for the variance band, "
            "or a variant the reference grid omits for this dataset).\n"
        )
    return text


def _sgn(x: float, band: float) -> int:
    return 0 if abs(x) < band else (1 if x > 0 else -1)


def fmt_orderings(ours: dict, refs: dict, band: float = MIN_BAND, holds=None) -> str:
    """The JAX tool's side-by-side orderings (deltas inside ``band`` count
    as ~0 for its ``same sign?`` column).  ``holds(ours, ref, band)``, when
    given, decides the last column instead (``holds?``): the comparison
    passes ``ordering_holds``."""
    if not any(k in ours or k in refs for k in ORDERING_KEYS):
        return (
            "n/a — single-code regime (the reference commits exactly one "
            "run for this dataset, so there are no variant relations to "
            "compare).\n"
        )
    lines = [
        f"| relation | this framework | reference | {'same sign' if holds is None else 'holds'}? |",
        "|---|---|---|---|",
    ]
    for k in ORDERING_KEYS:
        if k not in ours and k not in refs:
            continue
        o, r = ours.get(k), refs.get(k)
        same = "—"
        if holds is not None:
            same = "yes" if holds(o, r, band) else "NO"
        elif o is not None and r is not None:
            same = "yes" if _sgn(o, band) == _sgn(r, band) else "NO"
        fo = f"{o:+.4f}" if o is not None else "—"
        fr = f"{r:+.4f}" if r is not None else "—"
        lines.append(f"| {ORDERING_NAMES[k]} | {fo} | {fr} | {same} |")
    lines.append(
        f"\n(sign band ±{band:.4f} = the larger of 0.003 and the regime's "
        "measured duplicate-run spread, see lase_* runs)\n"
    )
    return "\n".join(lines)


def band_of(port: List[Dict], jax: List[Dict]) -> float:
    return max(MIN_BAND, duplicate_spread(port), duplicate_spread(jax))


def code_holds(p: Dict, j: Dict, band: float) -> bool:
    """Best R@20 and N@20 within ``band`` of the JAX run's, same shape."""
    return (abs(p["best_recall"] - j["best_recall"]) <= band
            and abs(p["best_ndcg"] - j["best_ndcg"]) <= band
            and p["shape"] == j["shape"])


def ordering_holds(port_delta: Optional[float], jax_delta: Optional[float], band: float) -> bool:
    """The port's delta has the JAX sign wherever the JAX delta lies
    outside ``band``."""
    if jax_delta is None or abs(jax_delta) <= band:
        return True
    return port_delta is not None and port_delta * jax_delta > 0


def compare(port: List[Dict], jax: List[Dict]) -> Dict:
    """The comparison of one regime: ``band``, per-code ``rows`` (JAX
    codes in order; ``port`` None where the port has no run),
    ``orderings`` [(key, port delta, JAX delta, holds)] and ``misses``
    (codes and relations that do not hold or have no port run)."""
    band = band_of(port, jax)
    by_code = {r["code"]: r for r in port}
    rows, misses = [], []
    for j in jax:
        p = by_code.get(j["code"])
        ok = p is not None and code_holds(p, j, band)
        rows.append(dict(code=j["code"], jax=j, port=p, holds=ok))
        if not ok:
            misses.append(j["code"])
    po, jo = orderings(port), orderings(jax)
    ords = []
    for k in ORDERING_KEYS:
        if k in po or k in jo:
            ok = ordering_holds(po.get(k), jo.get(k), band)
            ords.append((k, po.get(k), jo.get(k), ok))
            if not ok:
                misses.append(k)
    return dict(band=band, spread_port=duplicate_spread(port), spread_jax=duplicate_spread(jax),
                rows=rows, orderings=ords, misses=misses)


def missed_metrics(p: Dict, j: Dict, band: float) -> List[str]:
    out = [m for m in ("best_recall", "best_ndcg") if abs(p[m] - j[m]) > band]
    return out + (["shape"] if p["shape"] != j["shape"] else [])


def second_seed_rows(cmp: Dict, seconds: Dict[str, List[Dict]]) -> List[Dict]:
    """For each code of ``cmp`` that missed and has a run in a second-seed
    grid (``seconds``: seed label -> runs), the metrics it missed with the
    JAX value, the port's two values and whether they straddle it."""
    out = []
    for row in cmp["rows"]:
        p, j = row["port"], row["jax"]
        if row["holds"] or p is None:
            continue
        for label, runs in sorted(seconds.items()):
            q = next((r for r in runs if r["code"] == row["code"]), None)
            if q is None:
                continue
            for m in missed_metrics(p, j, cmp["band"]):
                if m == "shape":
                    straddles = q["shape"] == j["shape"]
                else:
                    straddles = min(p[m], q[m]) <= j[m] <= max(p[m], q[m])
                out.append(dict(code=row["code"], seed=label, metric=m, jax=j[m], port=p[m],
                                second=q[m], variance=straddles))
    return out


def jax_seed_rows(port: List[Dict], jax: List[Dict], jax_seeds: Dict[str, List[Dict]]):
    """The same rule with the roles swapped: for each code that misses, the
    port's value beside the JAX package's committed run and its run at
    another seed (``jax_seeds``: label -> runs), and whether the two JAX
    runs straddle the port's value (for the shape: whether one has the
    port's label)."""
    return second_seed_rows(compare(jax, port), jax_seeds)


def fmt_second_seeds(rows: List[Dict], ref: str = "JAX", ours: str = "port") -> str:
    if not rows:
        return ""
    lines = [f"| code | missed | {ref} | {ours} | {ours}, second seed | seed variance? |",
             "|---|---|---|---|---|---|"]
    for r in rows:
        vals = [r[k] if r["metric"] == "shape" else f"{r[k]:.4f}"
                for k in ("jax", "port", "second")]
        lines.append(f"| `{r['code']}` | {r['metric']} | {vals[0]} | {vals[1]} | "
                     f"{vals[2]} ({r['seed']}) | {'yes' if r['variance'] else 'NO'} |")
    return "\n".join(lines) + "\n"


def fmt_comparison(cmp: Dict) -> str:
    lines = [
        "| code | JAX best R@20 (ep) | port best R@20 (ep) | diff | JAX best N@20 | "
        "port best N@20 | JAX shape | port shape | holds |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for row in cmp["rows"]:
        j, p = row["jax"], row["port"]
        if p is None:
            lines.append(f"| `{row['code']}` | {j['best_recall']:.4f} (ep{j['best_epoch']}) | "
                         f"— | — | {j['best_ndcg']:.4f} | — | {j['shape']} | — | no run |")
            continue
        lines.append(
            f"| `{row['code']}` | {j['best_recall']:.4f} (ep{j['best_epoch']}) | "
            f"{p['best_recall']:.4f} (ep{p['best_epoch']}) | "
            f"{p['best_recall'] - j['best_recall']:+.4f} | {j['best_ndcg']:.4f} | "
            f"{p['best_ndcg']:.4f} | {j['shape']} | {p['shape']} | "
            f"{'yes' if row['holds'] else 'NO'} |")
    lines.append("")
    po = {k: d for k, d, _, _ in cmp["orderings"] if d is not None}
    jo = {k: d for k, _, d, _ in cmp["orderings"] if d is not None}
    lines.append(fmt_orderings(po, jo, cmp["band"], holds=ordering_holds))
    held = sum(r["holds"] for r in cmp["rows"])
    lines.append(
        f"Band ±{cmp['band']:.4f} = max(0.003, JAX spread {cmp['spread_jax']:.4f}, "
        f"port spread {cmp['spread_port']:.4f}); codes that hold: {held}/{len(cmp['rows'])}; "
        f"misses: {', '.join(cmp['misses']) or 'none'}.")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port_root", type=str, default=REPO,
                    help="Where the port's exp_torch_synth*/ grids are (the JAX "
                         "package's exp_synth*/ are read from the repository).")
    args = ap.parse_args(argv)

    out = ["# The port's experiment grids against the JAX package's\n"]
    for port_dir, jax_dir, desc in REGIME_MAP:
        port = read_runs(os.path.join(args.port_root, port_dir))
        jax = read_runs(os.path.join(REPO, jax_dir))
        out.append(f"\n## `{port_dir}/` against `{jax_dir}/` — {desc}\n")
        if not jax:
            out.append("_(no JAX runs found)_\n")
            continue
        cmp = compare(port, jax)
        out.append(fmt_comparison(cmp))
        out.append("The port's runs:\n")
        out.append(fmt_table(port, ref_suffixes={(_tag(r["code"]), _suffix(r["code"]))
                                                 for r in jax}))
        seconds = {os.path.basename(d): read_runs(d) for d in
                   sorted(glob.glob(os.path.join(args.port_root, port_dir, "seed*")))}
        second = second_seed_rows(cmp, seconds)
        if second:
            out.append("Misses rerun at a second seed:\n")
            out.append(fmt_second_seeds(second))
        jax_seeds = {os.path.basename(d): read_runs(d) for d in
                     sorted(glob.glob(os.path.join(args.port_root, port_dir, "jax_cpu_seed*")))}
        theirs = jax_seed_rows(port, jax, jax_seeds)
        if theirs:
            out.append("Misses against the JAX package's own run at another seed "
                       "(`tools/run_experiments.py` on the CPU):\n")
            out.append(fmt_second_seeds(theirs, ref="port", ours="JAX"))
    print("\n".join(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
