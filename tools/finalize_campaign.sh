#!/bin/bash
# Post-campaign acceptance artifacts:
#   1. full maze-benchmark zero-shot eval of each campaign run's final
#      checkpoint (100 episodes/env, reference eval.py protocol)
#   2. learning-curve + comparison figures
# Run AFTER tools/run_campaign.sh completes (needs the accelerator).
set -u
RUNS=${1:-/root/repo/results/runs}
OUT=/root/repo/results

for xpid in r3_accel_60b_s1 r3_robust_plr_25b_s1; do
  if [ -f "$RUNS/$xpid/model.tar" ]; then
    echo "=== eval $xpid (maze benchmark, 100 episodes/env) ==="
    python -m dcd_isaac_tpu.eval \
      --base_path="$RUNS" --prefix="$xpid" --benchmark=maze \
      --num_episodes=100 --result_path="$OUT/" \
      --accumulator=mean 2>&1 | tail -5
  fi
done

python tools/plot_curves.py "$RUNS/r3_accel_60b_s1/logs.csv" --smooth 3 \
  --title "60-block ACCEL (from empty), N=32 T=256" \
  --output "$OUT/figures/accel_curves.png" || true
python tools/plot_curves.py "$RUNS/r3_robust_plr_25b_s1/logs.csv" --smooth 3 \
  --title "25-block PLR-perp, N=32 T=256" \
  --output "$OUT/figures/robust_plr_curves.png" || true

if [ -f "$OUT/maze-r3_accel_60b_s1.csv" ]; then
  python tools/plot_eval_bars.py \
    -r /root/reference/results/minigrid_ood -r "$OUT" \
    -f mg_60_blocks-accel_20k_updates.csv -f maze-r3_accel_60b_s1.csv \
    -l "reference ACCEL (5 seeds)" -l "dcd_isaac_tpu ACCEL (seed 1)" \
    --output "$OUT/figures/accel_vs_reference.png" || true
fi
if [ -f "$OUT/maze-r3_robust_plr_25b_s1.csv" ]; then
  python tools/plot_eval_bars.py \
    -r /root/reference/results/minigrid_ood -r "$OUT" \
    -f mg_25_blocks-robust_plr-250M_steps.csv \
    -f maze-r3_robust_plr_25b_s1.csv \
    -l "reference PLR-perp (10 seeds, 250M)" \
    -l "dcd_isaac_tpu PLR-perp (seed 1, partial)" \
    --output "$OUT/figures/robust_plr_vs_reference.png" || true
fi

ls "$OUT"/*.csv 2>/dev/null
