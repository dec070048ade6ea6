#!/bin/bash
# Run experiment-grid jobs of tools/run_regime_grids.py side by side on one card.
#
#   bash gcn_recommendation_tpu_torch/tools/grid_lanes.sh OUT_DIR LANE [LANE ...]
#
# A LANE is one or more jobs joined by '+', run one after another; all lanes
# start together.  A job is REGIME:GRIDS:ONLY, e.g. books:base:brd_emb or
# zno:lase:brd (the lase grid reruns at --seed + 1, as run_regime_grids does).
# The four regime datasets are generated once, first
# (run_regime_grids.generate), into a fresh directory under $TMPDIR that
# this run alone uses; every job then trains on them with --skip_generate.
# After each job the CSVs of the codes it ran are copied to
# OUT_DIR/exp_torch_synth*/results/<code>/; the work directory, with its
# checkpoints, is removed at the end.  OUT_DIR gets logs/<job>.log,
# jobs.txt (each job's exit code and seconds, and the total), card.txt
# (nvidia-smi's name and power limit) and util.log (nvidia-smi's
# utilization once a second).  A training step is bound by the host's
# dispatch on these small graphs, so several processes keep one card busier
# than one does.  SEED, when set, passes --seed to every job's training
# (the datasets stay those of seed 42; SEED=43 gives the second-seed reruns
# that tools/regime_comparison.py reads).
set -u
OUT=$1; shift
ROOT=$(mktemp -d "${TMPDIR:-/tmp}/torch_grid.XXXXXX") || exit 1
trap 'rm -rf "$ROOT"' EXIT
MOD=gcn_recommendation_tpu_torch.tools.run_regime_grids
export PYTHONUNBUFFERED=1
mkdir -p "$OUT/logs"
if command -v nvidia-smi >/dev/null; then
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
fi
T0=$(date +%s)
python -c "import sys; from $MOD import GRID_REGIMES, generate
for r in GRID_REGIMES: generate(r, root=sys.argv[1])" "$ROOT" > "$OUT/logs/generate.log" 2>&1 \
  || { cat "$OUT/logs/generate.log"; exit 1; }
SMI=
if command -v nvidia-smi >/dev/null; then
  nvidia-smi --query-gpu=utilization.gpu --format=csv,noheader -lms 1000 > "$OUT/util.log" &
  SMI=$!
fi
PIDS=()
for lane in "$@"; do
  (
    IFS='+' read -ra JOBS <<< "$lane"
    for job in "${JOBS[@]}"; do
      IFS=: read -r regime grids only <<< "$job"
      name=${regime}_${grids}_${only}
      t=$(date +%s)
      OMP_NUM_THREADS=1 python -m $MOD --regime "$regime" --skip_generate --root "$ROOT" \
        --grids "$grids" --only "$only" ${SEED:+--seed $SEED} > "$OUT/logs/$name.log" 2>&1
      rc=$?
      exp=exp_torch_synth; [ "$regime" = books ] || exp=exp_torch_synth_$regime
      # the codes this job ran: <grid>_<E>e<C>c_<variant>, for each grid and --only variant
      IFS=, read -ra GS <<< "$grids"
      IFS=, read -ra OS <<< "${only:-*}"
      for g in "${GS[@]}"; do
        for o in "${OS[@]}"; do
          for d in "$ROOT/$exp/results/${g}_"*e*c_$o/; do
            [ -d "$d" ] || continue
            mkdir -p "$OUT/$exp/results/$(basename "$d")"
            cp "$d"*.csv "$OUT/$exp/results/$(basename "$d")/" 2>/dev/null
          done
        done
      done
      echo "job $name rc=$rc $(( $(date +%s) - t )) s" | tee -a "$OUT/jobs.txt"
    done
  ) &
  PIDS+=($!)
done
wait "${PIDS[@]}"
[ -n "$SMI" ] && { kill "$SMI"; wait "$SMI" 2>/dev/null; }
echo "total $(( $(date +%s) - T0 )) s" | tee -a "$OUT/jobs.txt"
grep -h "best val recall" "$OUT"/logs/*.log
! grep -q "rc=[1-9]" "$OUT/jobs.txt"
