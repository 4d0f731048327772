#!/bin/bash
# Round-3 training campaign.
#
# Two configs from the reference grid, run sequentially on one
# accelerator, logging the reference CSV surface (logs.csv with in-training
# zero-shot eval every --test_interval updates, level_weights, archives):
#
#   1. 60-block ACCEL-from-empty  (grid_configs/minigrid/60_blocks_uniform/
#      mg_60b_uni_accel_empty.json), budget trimmed from 250M steps to a
#      wall-clock-bounded slice (~20k cycles) of the 20k-update reference
#      run.
#   2. 25-block PLR-perp (mg_25b_robust_plr.json), partial slice of the
#      reference's 30.5k-cycle budget.
#
# Usage: bash tools/run_campaign.sh [logdir]
# Budgets are overridable (update cycles; steps = updates * 32 * 256) so a
# wall-clock-bounded slice can exit cleanly through the final-eval path:
#   ACCEL_UPDATES=13500 PLR_UPDATES=4000 bash tools/run_campaign.sh
#
# NOTE (reproduction): the committed round-3 artifacts (results/runs/
# r3_accel_60b_s1, r3_robust_plr_25b_s1) were produced with
#   ACCEL_UPDATES=12000 PLR_UPDATES=2500
# — a wall-clock-bounded slice of the reference budgets, not the defaults
# below. Round-4 multi-seed campaigns use tools/run_campaign_r4.sh.
set -u
LOGDIR=${1:-/root/repo/results/runs}
ACCEL_UPDATES=${ACCEL_UPDATES:-20000}
PLR_UPDATES=${PLR_UPDATES:-14000}
SKIP_ACCEL=${SKIP_ACCEL:-0}
mkdir -p "$LOGDIR"

COMMON="--log_dir=$LOGDIR --checkpoint=True --log_interval=25 \
 --num_processes=32 --num_steps=256 --ppo_epoch=5 --num_mini_batch=1 \
 --handle_timelimits=True --lr=0.0001 --gamma=0.995 \
 --recurrent_arch=lstm --recurrent_agent=True \
 --recurrent_adversary_env=False --recurrent_hidden_size=256 \
 --log_action_complexity=True --log_plr_buffer_stats=True \
 --log_replay_complexity=True --reject_unsolvable_seeds=False \
 --test_interval=250 --weight_log_interval=100 \
 --test_env_names=MultiGrid-SixteenRooms-v0,MultiGrid-Labyrinth-v0,MultiGrid-Maze-v0"

echo "=== campaign: ACCEL 60-block (empty start) ==="
[ "$SKIP_ACCEL" = "1" ] || python -m dcd_isaac_tpu.train $COMMON \
  --xpid=r3_accel_60b_s1 --seed=1 \
  --env_name=MultiGrid-GoalLastEmptyAdversarialEnv-Edit-v0 \
  --ued_algo=domain_randomization \
  --num_env_steps=$((ACCEL_UPDATES * 8192)) \
  --entropy_coef=0.0 --adv_entropy_coef=0.0 \
  --use_plr=True --level_replay_prob=0.8 --level_replay_rho=0.5 \
  --level_replay_seed_buffer_size=4000 --level_replay_temperature=0.3 \
  --level_replay_strategy=positive_value_loss \
  --level_replay_score_transform=rank \
  --no_exploratory_grad_updates=True \
  --use_editor=True --level_editor_prob=1.0 --level_editor_method=random \
  --num_edits=5 --base_levels=easy \
  --checkpoint_basis=student_grad_updates \
  --checkpoint_interval=500 --archive_interval=5000 \
  --screenshot_interval=2000 \
  > "$LOGDIR/accel_60b.out" 2>&1
echo "=== ACCEL run done rc=$? ==="

echo "=== campaign: PLR-perp 25-block ==="
python -m dcd_isaac_tpu.train $COMMON \
  --xpid=r3_robust_plr_25b_s1 --seed=1 \
  --env_name=MultiGrid-GoalLastFewerBlocksAdversarial-v0 \
  --ued_algo=domain_randomization \
  --num_env_steps=$((PLR_UPDATES * 8192)) \
  --entropy_coef=0.01 \
  --use_plr=True --level_replay_prob=0.5 --level_replay_rho=0.5 \
  --level_replay_seed_buffer_size=4000 --level_replay_temperature=0.1 \
  --level_replay_strategy=grounded_signed_value_loss \
  --level_replay_score_transform=rank --staleness_coef=0.3 \
  --no_exploratory_grad_updates=True \
  --checkpoint_interval=500 --archive_interval=10000 \
  > "$LOGDIR/robust_plr_25b.out" 2>&1
echo "=== PLR-perp run done rc=$? ==="
