import os
import sys

# Tests run on a virtual 8-device CPU mesh so sharding paths are exercised
# without accelerators (SURVEY.md §4d).  An explicitly set JAX_PLATFORMS is
# kept: the chip tests run with JAX_PLATFORMS=cuda
# (`JAX_PLATFORMS=cuda python -m pytest -m chip tests/`).
os.environ.setdefault('JAX_PLATFORMS', 'cpu')
flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8'
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dcd_isaac_tpu.utils.compile_cache import enable_persistent_cache  # noqa: E402

# Persistent XLA compilation cache, by the program's own rules (the
# JAX_COMPILATION_CACHE_DIR directory when set, else <checkout>/.jax_cache):
# test time is compile-dominated, and the cache is keyed by HLO hash so it
# invalidates itself when code changes.
enable_persistent_cache()

# ---------------------------------------------------------------------------
# Fast/slow split: the default selection
# `pytest tests/ -m "not slow"` must stay under 5 minutes; everything else
# (end-to-end runner matrix, mesh training, physics replays — measured
# >=10s each on the 2-core CI host) is opted into with `pytest tests/`.
# Durations measured 2026-08-20 with --durations=0; re-measure when adding
# heavy tests.
# ---------------------------------------------------------------------------
_SLOW = (
    'test_geo_polar.py::TestRunnerTrackStats::'
    'test_carracing_stats_have_geo_complexity',
    'test_geo_polar.py::TestPolarTrack::test_vanilla_eval_env_runs',
    'test_mesh_train.py::TestMeshTrain',               # whole class
    'test_runner.py::TestUEDMatrix::test_alp_gmm_walker',
    'test_runner.py::TestUEDMatrix::test_accel',
    'test_runner.py::TestUEDMatrix::test_repaired',
    'test_runner.py::TestUEDMatrix::test_robust_plr',
    'test_runner.py::TestUEDMatrix::test_dr',
    'test_runner.py::TestUEDMatrix::test_flexible_paired',
    'test_runner.py::TestUEDMatrix::test_minimax',
    'test_round2_fixes.py::TestRunnerBookkeeping::test_host_state_roundtrip',
    'test_round2_fixes.py::TestRunnerBookkeeping::test_replay_complexity_flag',
    'test_round2_fixes.py::TestRunnerBookkeeping::'
    'test_latest_env_stats_on_replay',
    'test_round2_fixes.py::TestRunnerBookkeeping::'
    'test_antagonist_returns_tracked',
    'test_finetune.py::test_finetune_loads_agent_only',
    'test_carracing.py::TestEnv::test_vmap_batch',
    'test_carracing.py::TestSparseRewards::'
    'test_categorical_teacher_masks_and_logprobs',
    'test_carracing.py::TestSparseRewards::test_teacher_goal_and_start_steps',
    'test_fixed_seed_plr.py::TestFixedSeedEndToEnd::test_train_fixed_seed_mode',
    'test_fixed_seed_plr.py::TestBatchedPromote::test_fill_then_evict_lowest',
    'test_fixed_seed_plr.py::TestBatchedPromote::'
    'test_overflow_staged_highest_win',
    'test_runner.py::TestUEDMatrix::test_paired',
    'test_algos.py::TestRolloutHarness::test_ppo_update_runs_and_discard_grad',
    'test_algos.py::TestRolloutHarness::test_rollout_shapes_and_episodes',
    'test_round2_fixes.py::TestDeterministicAction::'
    'test_evaluator_deterministic_multigrid',
    'test_multigrid_golden_trace.py::TestResetToLevel::'
    'test_level_roundtrip_replays_identically',
    'test_walker.py::TestWalkerEnv::test_vmap_batch',
    'test_walker.py::TestWalkerEnv::test_mutate_clips_to_ranges',
    'test_carracing.py::TestBezier::test_closed_smooth_curve',
    'test_carracing.py::TestEnv::test_adversary_design',
    '[goal_first_50]',                                  # heaviest golden traces
    '[dup_cells]',
    '[opaque_25]',
    'test_carracing_box2d_parity.py::TestTrackGeometry::'
    'test_road_membership_matches_tile_quads',
    'test_carracing_box2d_parity.py::TestTileRewards::'
    'test_closed_loop_driving_parity',
    'test_carracing_box2d_parity.py::TestRenderRoadMask',
)


@pytest.fixture(autouse=True)
def _chip_only(request):
    """`chip`-marked tests need a GPU; decided here, at run time, so every
    xdist worker collects the same tests."""
    if request.node.get_closest_marker('chip') is None:
        return
    platform = jax.devices()[0].platform
    if platform != 'gpu':
        pytest.skip(f'chip test: needs a GPU, JAX found {platform!r} '
                    '(run `JAX_PLATFORMS=cuda python -m pytest -m chip '
                    'tests/` on the card)')


def pytest_collection_modifyitems(config, items):
    for item in items:
        if any(s in item.nodeid for s in _SLOW):
            item.add_marker(pytest.mark.slow)
