"""Generate the synthetic regime datasets and run the experiment grid on each.

Counterpart of the JAX package's ``tools/run_regime_grids.py``, with the
port's own copies of its tables ``EMB_NOISE`` and ``BRAND_STYLE``; the
regime definitions are ``REGIMES`` of the port's
``tools/calibrate_regimes.py``, which calibrates them, as in the JAX
package.  Each regime's dataset
is made by the port's generator (``data/synthetic.py``) and its grid run
by the port's ``tools/run_experiments.py``; the ``lase`` pass reruns
``brd,nob`` at ``--seed`` + 1, the duplicate-config runs that measure the
run-to-run spread.

It writes into its own directories, never into the JAX package's:
datasets under ``dataset/torch_synthetic_<regime>/processed_data_<core>/``,
results under ``exp_torch_synth/`` (books), ``exp_torch_synth_dense/``,
``exp_torch_synth_zno/`` and ``exp_torch_synth_sport/``.

    python -m gcn_recommendation_tpu_torch.tools.run_regime_grids --regime books
    python -m gcn_recommendation_tpu_torch.tools.run_regime_grids --regime all
    python -m gcn_recommendation_tpu_torch.tools.run_regime_grids --regime zno \\
        --grids loss --only brd

``--skip_generate`` trains on the datasets already written by
``generate`` (several grid processes can then share one card without
racing on the files; ``tools/grid_lanes.sh`` runs them so).  Runs on the card unless
``--device cpu`` is given; ``--root`` moves both trees (the tests use it).
"""

from __future__ import annotations

import argparse
import os
import time

from gcn_recommendation_tpu_torch.tools.calibrate_regimes import REGIMES

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Content-embedding noise per regime (dense's content is misleading:
# emb_style='mislead' in its regime dict).
EMB_NOISE = {"dense": 0.5, "zno": 1.5, "sport": 1.5, "books": 0.2}
# Brands drawn at random: every reference dataset shows a brand delta
# within its duplicate-run band, which uncorrelated brands reproduce.
BRAND_STYLE = "random"
GRID_REGIMES = ("books", "dense", "zno", "sport")


def dataset_dir(regime: str, core: int = 16, root: str = REPO) -> str:
    return os.path.join(root, "dataset", f"torch_synthetic_{regime}", f"processed_data_{core}")


def exp_dir(regime: str, root: str = REPO) -> str:
    return os.path.join(root, "exp_torch_synth" if regime == "books" else f"exp_torch_synth_{regime}")


def generate(regime: str, core: int = 16, seed: int = 42, emb_noise: float = None,
             root: str = REPO) -> str:
    from gcn_recommendation_tpu_torch.data.synthetic import generate_synthetic_dataset

    spec = REGIMES[regime]
    out = dataset_dir(regime, core, root)
    t0 = time.perf_counter()
    generate_synthetic_dataset(
        out,
        num_users=spec["num_users"],
        num_items=spec["num_items"],
        num_brands=spec["num_brands"],
        mean_degree=spec["mean_degree"],
        core=core,
        seed=seed,
        embedding_dim=64,
        style="latent",
        latent_dim=spec["latent_dim"],
        temperature=spec["temperature"],
        pop_scale=spec.get("pop_scale", 0.5),
        emb_noise=EMB_NOISE[regime] if emb_noise is None else emb_noise,
        brand_style=BRAND_STYLE,
        split=spec.get("split", "random"),
        pop_df=spec.get("pop_df"),
        pop_zipf=spec.get("pop_zipf"),
        deg_sigma=spec.get("deg_sigma", 0.5),
        spectrum=spec.get("spectrum", 0.0),
        emb_style=spec.get("emb_style", "informative"),
        rank_key=spec.get("rank_key", "full"),
    )
    print(f"[{regime}] dataset written to {out} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def main(argv=None):
    from gcn_recommendation_tpu_torch.tools import run_experiments

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--regime", choices=[*GRID_REGIMES, "all"], default=None,
                    help="Default: dense+zno; 'all' runs books, dense, zno, sport.")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--core", type=int, default=16)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--grids", type=str, default="base,loss,lase",
                    help="Passed through to run_experiments.")
    ap.add_argument("--only", type=str, default=None)
    ap.add_argument("--emb_noise", type=float, default=None,
                    help="Override the regime's content-embedding noise "
                         "(interactions are unaffected).")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--skip_generate", action="store_true",
                    help="Train on the datasets already written.")
    ap.add_argument("--root", type=str, default=REPO,
                    help="Where dataset/ and exp_torch_synth*/ go (default: the repo).")
    args = ap.parse_args(argv)

    if args.regime == "all":
        regimes = list(GRID_REGIMES)
    else:
        regimes = [args.regime] if args.regime else ["dense", "zno"]
    for regime in regimes:
        if args.skip_generate:
            processed = dataset_dir(regime, args.core, args.root)
        else:
            processed = generate(regime, core=args.core, seed=args.seed,
                                 emb_noise=args.emb_noise, root=args.root)

        def run_grid(grids: str, only, seed: int):
            argv = ["--processed_dir", processed, "--exp_name", exp_dir(regime, args.root),
                    "--epochs", str(args.epochs), "--core", str(args.core),
                    "--grids", grids, "--seed", str(seed), "--device", args.device]
            if only:
                argv += ["--only", only]
            print(f"[{regime}] running grid: {' '.join(argv)}", flush=True)
            t0 = time.perf_counter()
            run_experiments.main(argv)
            print(f"[{regime}] grid {grids} took {time.perf_counter() - t0:.1f} s", flush=True)

        wanted = args.grids.split(",")
        main_grids = ",".join(g for g in wanted if g != "lase")
        if main_grids:
            run_grid(main_grids, args.only, args.seed)
        if "lase" in wanted:
            # the lase_* codes are duplicate-config reruns of base brd/nob
            # that differ only by the RNG: seed + 1
            run_grid("lase", args.only or "brd,nob", args.seed + 1)


if __name__ == "__main__":
    main()
