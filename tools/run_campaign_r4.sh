#!/bin/bash
# Round-4 training campaign.
#
# Stages (each skippable / budget-overridable via env vars):
#   A. acceptance: 60-block ACCEL-from-empty x ACCEL_SEEDS seeds at the
#      full reference budget (20k updates; reference
#      results/minigrid_ood/mg_60_blocks-accel_20k_updates.csv is 5 seeds
#      x 20k), then a 100-episode maze benchmark per seed into ONE
#      per-seed-column CSV.
#   B. 25-block PLR-perp extended slice (reference budget 30.5k cycles /
#      250M steps; r3 ran 2.5k).
#   C. BipedalWalker ACCEL slice (reference budget 2B steps = 61k cycles;
#      bipedal8d-accel_20k-updates.csv), + bipedal benchmark eval.
#   D. CarRacing F1 PLR-perp at the FULL reference budget (5.5M steps =
#      2750 cycles; f1-robust_plr-5M_steps.csv), + f1 benchmark eval.
#
# All runs use --cycles_per_dispatch to batch K update cycles into one
# compiled program (the r3 campaign was launch-latency-bound at 17k
# steps/s, PERF.md r3). Intervals are multiples of K so the dispatch size
# stays constant (single compile per config).
#
# Usage: bash tools/run_campaign_r4.sh [logdir]
#   ACCEL_SEEDS="1 2 3" ACCEL_UPDATES=20000 PLR_UPDATES=8000 \
#   WALKER_UPDATES=4000 CR_UPDATES=2750 bash tools/run_campaign_r4.sh
set -u
LOGDIR=${1:-/root/repo/results/runs}
ACCEL_SEEDS=${ACCEL_SEEDS:-"1 2 3"}
ACCEL_UPDATES=${ACCEL_UPDATES:-20000}
PLR_UPDATES=${PLR_UPDATES:-8000}
WALKER_UPDATES=${WALKER_UPDATES:-4000}
WALKER_TEST_IV=${WALKER_TEST_IV:-100}
CR_UPDATES=${CR_UPDATES:-2750}
K=${K:-50}          # multigrid dispatch size
# walker/carracing cycles are much larger programs (2048-step
# physics scans / 96x96 renders); dispatches of 10 of them at most
K_HEAVY=${K_HEAVY:-10}
SKIP_ACCEL=${SKIP_ACCEL:-0}
SKIP_PLR=${SKIP_PLR:-0}
SKIP_WALKER=${SKIP_WALKER:-0}
SKIP_CR=${SKIP_CR:-0}
mkdir -p "$LOGDIR"
cd "$(dirname "$0")/.."

MG_COMMON="--log_dir=$LOGDIR --checkpoint=True --log_interval=25 \
 --num_processes=32 --num_steps=256 --ppo_epoch=5 --num_mini_batch=1 \
 --handle_timelimits=True --lr=0.0001 --gamma=0.995 \
 --recurrent_arch=lstm --recurrent_agent=True \
 --recurrent_adversary_env=False --recurrent_hidden_size=256 \
 --log_action_complexity=True --log_plr_buffer_stats=True \
 --log_replay_complexity=True --reject_unsolvable_seeds=False \
 --cycles_per_dispatch=$K \
 --test_interval=250 --test_num_episodes=20 --weight_log_interval=100 \
 --test_env_names=MultiGrid-SixteenRooms-v0,MultiGrid-Labyrinth-v0,MultiGrid-Maze-v0"

if [ "$SKIP_ACCEL" != "1" ]; then
  for SEED in $ACCEL_SEEDS; do
    echo "=== campaign A: ACCEL 60-block seed $SEED ($ACCEL_UPDATES updates) ==="
    python -m dcd_isaac_tpu.train $MG_COMMON \
      --xpid=r4_accel_60b_s$SEED --seed=$SEED \
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
      --screenshot_interval=2500 \
      > "$LOGDIR/r4_accel_60b_s$SEED.out" 2>&1
    echo "=== seed $SEED done rc=$? ==="
  done
  echo "=== campaign A eval: 100-episode maze benchmark, per-seed CSV ==="
  python -m dcd_isaac_tpu.eval --base_path="$LOGDIR" \
    --prefix='r4_accel_60b_s*' --benchmark=maze --num_episodes=100 \
    --result_path=results/ \
    > "$LOGDIR/r4_accel_eval.out" 2>&1
  echo "=== eval done rc=$? ==="
fi

if [ "$SKIP_PLR" != "1" ]; then
  echo "=== campaign B: PLR-perp 25-block ($PLR_UPDATES updates) ==="
  python -m dcd_isaac_tpu.train $MG_COMMON \
    --xpid=r4_robust_plr_25b_s1 --seed=1 \
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
    > "$LOGDIR/r4_robust_plr_25b.out" 2>&1
  echo "=== PLR-perp done rc=$? ==="
  python -m dcd_isaac_tpu.eval --base_path="$LOGDIR" \
    --prefix='r4_robust_plr_25b_s*' --benchmark=maze --num_episodes=100 \
    --result_path=results/ \
    > "$LOGDIR/r4_plr_eval.out" 2>&1
fi

if [ "$SKIP_WALKER" != "1" ]; then
  echo "=== campaign C: BipedalWalker ACCEL slice ($WALKER_UPDATES updates) ==="
  # grid_configs/bipedal/bipedal_accel.json settings; budget trimmed from
  # 2B steps (61k cycles) to a wall-clock slice
  python -m dcd_isaac_tpu.train \
    --log_dir="$LOGDIR" --checkpoint=True --log_interval=10 \
    --xpid=r4_walker_accel_s1 --seed=1 \
    --env_name=BipedalWalker-Adversarial-Easy-v0 \
    --ued_algo=domain_randomization \
    --num_processes=16 --num_steps=2048 \
    --num_env_steps=$((WALKER_UPDATES * 32768)) \
    --ppo_epoch=5 --num_mini_batch=32 --normalize_returns=True \
    --recurrent_agent=False --recurrent_adversary_env=False \
    --lr=3e-4 --max_grad_norm=0.5 --gamma=0.99 --gae_lambda=0.9 \
    --value_loss_coef=0.5 --entropy_coef=0.001 --adv_entropy_coef=0.01 \
    --clip_value_loss=False --clip_param=0.2 --handle_timelimits=True \
    --use_plr=True --level_replay_strategy=positive_value_loss \
    --level_replay_score_transform=rank --level_replay_prob=0.9 \
    --level_replay_rho=0.5 --level_replay_seed_buffer_size=1000 \
    --staleness_coef=0.5 --no_exploratory_grad_updates=True \
    --use_editor=True --level_editor_prob=1.0 \
    --level_editor_method=random --num_edits=3 --base_levels=easy \
    --log_plr_buffer_stats=True --log_replay_complexity=True \
    --cycles_per_dispatch=$K_HEAVY --rollout_unroll=1 \
    --test_interval=$WALKER_TEST_IV --test_num_episodes=10 \
    --test_env_names=BipedalWalker-v3,BipedalWalkerHardcore-v3,BipedalWalker-Med-Stairs-v0 \
    --checkpoint_basis=student_grad_updates \
    --checkpoint_interval=500 --archive_interval=5000 \
    > "$LOGDIR/r4_walker_accel.out" 2>&1
  echo "=== walker done rc=$? ==="
  python -m dcd_isaac_tpu.eval --base_path="$LOGDIR" \
    --prefix='r4_walker_accel_s*' --benchmark=bipedal --num_episodes=100 \
    --result_path=results/ \
    > "$LOGDIR/r4_walker_eval.out" 2>&1
fi

if [ "$SKIP_CR" != "1" ]; then
  echo "=== campaign D: CarRacing F1 PLR-perp ($CR_UPDATES updates, full 5.5M-step reference budget at 2750) ==="
  # grid_configs/car_racing/cr_robust_plr.json settings
  python -m dcd_isaac_tpu.train \
    --log_dir="$LOGDIR" --checkpoint=True --log_interval=10 \
    --xpid=r4_cr_robust_plr_s1 --seed=1 \
    --env_name=CarRacing-Bezier-Adversarial-v0 \
    --ued_algo=domain_randomization \
    --num_processes=16 --num_steps=125 \
    --num_env_steps=$((CR_UPDATES * 2000)) \
    --ppo_epoch=8 --num_mini_batch=4 --normalize_returns=True \
    --grayscale=False --crop_frame=False --num_action_repeat=8 \
    --frame_stack=4 --recurrent_agent=False \
    --recurrent_adversary_env=False \
    --lr=3e-4 --max_grad_norm=0.5 --gamma=0.99 --gae_lambda=0.9 \
    --value_loss_coef=0.5 --entropy_coef=0.0 --adv_entropy_coef=0.01 \
    --clip_value_loss=False --clip_param=0.2 --handle_timelimits=True \
    --reward_shaping=True --use_categorical_adv=True \
    --use_plr=True --level_replay_strategy=positive_value_loss \
    --level_replay_score_transform=power --level_replay_temperature=1.0 \
    --staleness_coef=0.7 --level_replay_prob=0.5 --level_replay_rho=0.5 \
    --level_replay_seed_buffer_size=8000 \
    --no_exploratory_grad_updates=True \
    --log_plr_buffer_stats=True --log_replay_complexity=True \
    --cycles_per_dispatch=$K_HEAVY --rollout_unroll=1 \
    --test_interval=100 --test_num_episodes=5 \
    --test_env_names=CarRacing-Vanilla-v0,CarRacingF1-Italy-v0 \
    --checkpoint_interval=250 --archive_interval=1000 \
    > "$LOGDIR/r4_cr_robust_plr.out" 2>&1
  echo "=== carracing done rc=$? ==="
  python -m dcd_isaac_tpu.eval --base_path="$LOGDIR" \
    --prefix='r4_cr_robust_plr_s*' --benchmark=f1 --num_episodes=10 \
    --result_path=results/ \
    > "$LOGDIR/r4_cr_eval.out" 2>&1
fi
echo "=== campaign r4 complete ==="
