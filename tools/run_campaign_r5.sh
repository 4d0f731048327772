#!/bin/bash
# Round-5 training campaign.
#
# Stages (run selectively via STAGES="w p ae ps"):
#   w  - BipedalWalker ACCEL at the full reference budget (2B steps /
#        61k cycles; published table is the 20k-student-grad-update
#        archive), with a retry-resume safety net. Round 4's blocker —
#        the bitcast-NaN seed lane poisoning the PLR buffer at cycle
#        ~255 — is fixed (envs/seeds.py; tests/test_level_encoding.py),
#        so this run doubles as the fix verification. Harvested at
#        whatever archive it reaches; checkpoints every 500 grad updates.
#   p  - Flagship 25-block PAIRED x PAIRED_SEEDS at the reference budget
#        (250M steps; grid_configs/minigrid/25_blocks/mg_25b_paired.json)
#        - the first trained PAIRED campaign (VERDICT r4 missing #2).
#   ae - Extend the three r4 60-block ACCEL seeds from 20k cycles to the
#        true 20k STUDENT GRAD UPDATES budget (VERDICT r4 weak #2: the
#        reference's checkpoint_basis is student_grad_updates, and 20k
#        cycles at replay_prob 0.8 is only ~16k updates). Archives land
#        at exactly 20k grad updates; evals use that archive.
#   ps - 2 more seeds of the 250M-step 25-block PLR-perp run (VERDICT
#        r4 missing #4); mean/std published beside the reference's
#        10-seed table.
#
# Usage:  STAGES="w" bash tools/run_campaign_r5.sh
#         STAGES="p ae ps" PAIRED_SEEDS="1 2" bash tools/run_campaign_r5.sh
set -u
LOGDIR=${1:-/root/repo/results/runs}
STAGES=${STAGES:-"w"}
PAIRED_SEEDS=${PAIRED_SEEDS:-"1 2"}
PLR_SEEDS=${PLR_SEEDS:-"2 3"}
ACCEL_SEEDS=${ACCEL_SEEDS:-"1 2 3"}
WALKER_UPDATES=${WALKER_UPDATES:-61035}   # 2B steps / (16*2048)
WALKER_RETRIES=${WALKER_RETRIES:-20}
PAIRED_UPDATES=${PAIRED_UPDATES:-30518}   # 250M steps / (32*256)
PLR_UPDATES=${PLR_UPDATES:-30518}
ACCEL_EXT_UPDATES=${ACCEL_EXT_UPDATES:-25500}  # ~20k grad updates @ 0.8 replay
K=${K:-50}
K_HEAVY=${K_HEAVY:-10}
# Walker dispatch size. K=5 was a cap for the earlier accelerator
# runtime, which ended any device program running longer than ~60 s; the
# GPU has no such per-dispatch limit (ROADMAP C4), so the cap can go once
# long walker dispatches are measured there.
WALKER_K=${WALKER_K:-5}
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

run_stage() { case " $STAGES " in *" $1 "*) return 0;; *) return 1;; esac; }

if run_stage w; then
  echo "=== stage W: BipedalWalker ACCEL, full budget ($WALKER_UPDATES cycles) ==="
  # grid_configs/bipedal/bipedal_accel.json settings
  attempt=0
  while [ $attempt -lt "$WALKER_RETRIES" ]; do
    attempt=$((attempt + 1))
    echo "--- walker attempt $attempt ---"
    python -m dcd_isaac_tpu.train \
      --log_dir="$LOGDIR" --checkpoint=True --log_interval=10 \
      --xpid=r5_walker_accel_s1 --seed=1 \
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
      --cycles_per_dispatch=$WALKER_K --rollout_unroll=1 --debug_nans=True \
      --test_interval=200 --test_num_episodes=10 \
      --test_env_names=BipedalWalker-v3,BipedalWalkerHardcore-v3,BipedalWalker-Med-Stairs-v0 \
      --checkpoint_basis=student_grad_updates \
      --checkpoint_interval=100 --archive_interval=5000 \
      >> "$LOGDIR/r5_walker_accel.out" 2>&1
    rc=$?
    echo "--- walker attempt $attempt rc=$rc ---"
    [ $rc -eq 0 ] && break
    sleep 5
  done
  python -m dcd_isaac_tpu.eval --base_path="$LOGDIR" \
    --prefix='r5_walker_accel_s*' --benchmark=bipedal --num_episodes=100 \
    --result_path=results/ \
    > "$LOGDIR/r5_walker_eval.out" 2>&1
fi

if run_stage p; then
  for SEED in $PAIRED_SEEDS; do
    echo "=== stage P: 25-block PAIRED seed $SEED ($PAIRED_UPDATES updates) ==="
    # grid_configs/minigrid/25_blocks/mg_25b_paired.json settings
    python -m dcd_isaac_tpu.train $MG_COMMON \
      --xpid=r5_paired_25b_s$SEED --seed=$SEED \
      --env_name=MultiGrid-GoalLastFewerBlocksAdversarial-v0 \
      --ued_algo=paired \
      --recurrent_adversary_env=True \
      --num_env_steps=$((PAIRED_UPDATES * 8192)) \
      --entropy_coef=0.0 --adv_entropy_coef=0.0 \
      --checkpoint_interval=1000 --archive_interval=$PAIRED_UPDATES \
      > "$LOGDIR/r5_paired_25b_s$SEED.out" 2>&1
    echo "=== paired seed $SEED done rc=$? ==="
  done
  python -m dcd_isaac_tpu.eval --base_path="$LOGDIR" \
    --prefix='r5_paired_25b_s*' --benchmark=maze --num_episodes=100 \
    --result_path=results/ \
    > "$LOGDIR/r5_paired_eval.out" 2>&1
fi

if run_stage ae; then
  for SEED in $ACCEL_SEEDS; do
    echo "=== stage AE: extend r4 ACCEL 60b seed $SEED to 20k grad updates ==="
    # resume-in-place of the r4 run; checkpoint basis switches to
    # student_grad_updates so the archive lands exactly at 20000
    python -m dcd_isaac_tpu.train $MG_COMMON \
      --xpid=r4_accel_60b_s$SEED --seed=$SEED \
      --env_name=MultiGrid-GoalLastEmptyAdversarialEnv-Edit-v0 \
      --ued_algo=domain_randomization \
      --num_env_steps=$((ACCEL_EXT_UPDATES * 8192)) \
      --entropy_coef=0.0 --adv_entropy_coef=0.0 \
      --use_plr=True --level_replay_prob=0.8 --level_replay_rho=0.5 \
      --level_replay_seed_buffer_size=4000 --level_replay_temperature=0.3 \
      --level_replay_strategy=positive_value_loss \
      --level_replay_score_transform=rank \
      --no_exploratory_grad_updates=True \
      --use_editor=True --level_editor_prob=1.0 --level_editor_method=random \
      --num_edits=5 --base_levels=easy \
      --checkpoint_basis=student_grad_updates \
      --checkpoint_interval=100 --archive_interval=5000 \
      --screenshot_interval=2500 \
      > "$LOGDIR/r5_accel_ext_s$SEED.out" 2>&1
    echo "=== accel-ext seed $SEED done rc=$? ==="
  done
  # 20k-GRAD-UPDATE archive eval; separate result dir so the r4
  # (16k-update) CSV of the same prefix isn't overwritten
  python -m dcd_isaac_tpu.eval --base_path="$LOGDIR" \
    --prefix='r4_accel_60b_s*' --model_tar=model_20000 \
    --benchmark=maze --num_episodes=100 \
    --result_path=results/accel_20kgu/ \
    > "$LOGDIR/r5_accel_ext_eval.out" 2>&1
fi

if run_stage ps; then
  for SEED in $PLR_SEEDS; do
    echo "=== stage PS: 25-block PLR-perp 250M seed $SEED ==="
    # grid_configs/minigrid/25_blocks/mg_25b_robust_plr.json settings
    python -m dcd_isaac_tpu.train $MG_COMMON \
      --xpid=r5_robust_plr_25b_s$SEED --seed=$SEED \
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
      > "$LOGDIR/r5_robust_plr_25b_s$SEED.out" 2>&1
    echo "=== plr seed $SEED done rc=$? ==="
  done
  # one 3-seed CSV: alias the r4 seed-1 run under the r5 prefix
  [ -e "$LOGDIR/r5_robust_plr_25b_s1" ] || \
    ln -s r4_robust_plr_25b_s1 "$LOGDIR/r5_robust_plr_25b_s1"
  python -m dcd_isaac_tpu.eval --base_path="$LOGDIR" \
    --prefix='r5_robust_plr_25b_s*' --benchmark=maze --num_episodes=100 \
    --result_path=results/ \
    > "$LOGDIR/r5_plr_eval.out" 2>&1
fi

if run_stage crbench; then
  echo "=== stage CRBENCH: CarRacing throughput A/B (MXU nearest-tile + unrolled repeat) ==="
  rm -rf "$LOGDIR/r5_cr_bench"
  # same config as the r4 campaign, 150 updates — sps in logs.csv is the
  # measurement (r4 sustained ~1.2k env-steps/s)
  python -m dcd_isaac_tpu.train \
    --log_dir="$LOGDIR" --checkpoint=False --log_interval=10 \
    --xpid=r5_cr_bench --seed=7 \
    --env_name=CarRacing-Bezier-Adversarial-v0 \
    --ued_algo=domain_randomization \
    --num_processes=16 --num_steps=125 \
    --num_env_steps=$((150 * 2000)) \
    --ppo_epoch=8 --num_mini_batch=4 --normalize_returns=True \
    --lr=3e-4 --gamma=0.99 --gae_lambda=0.9 --clip_param=0.2 \
    --entropy_coef=0.0 --handle_timelimits=True \
    --use_categorical_adv=True \
    --use_plr=True --level_replay_strategy=positive_value_loss \
    --level_replay_score_transform=rank --level_replay_prob=0.5 \
    --level_replay_rho=0.5 --level_replay_seed_buffer_size=8000 \
    --staleness_coef=0.7 --no_exploratory_grad_updates=True \
    --cycles_per_dispatch=$K_HEAVY \
    --test_interval=0 --test_env_names='' \
    > "$LOGDIR/r5_cr_bench.out" 2>&1
  echo "=== crbench done rc=$? ==="
fi

if run_stage creval; then
  echo "=== stage CREVAL: r4 CR checkpoint at 100 episodes/track (reference protocol) ==="
  python -m dcd_isaac_tpu.eval --base_path="$LOGDIR" \
    --prefix='r4_cr_robust_plr_s*' --benchmark=f1 --num_episodes=100 \
    --result_path=results/cr_100ep/ \
    > "$LOGDIR/r5_cr_eval100.out" 2>&1
  echo "=== creval done rc=$? ==="
fi

echo "=== campaign r5 stages [$STAGES] complete ==="
