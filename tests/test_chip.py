"""Numerics on the card: the CPU-pinned parity checks, run on the GPU.

Every test here is marked ``chip`` and skips without a GPU (decided at run
time by the fixture in conftest.py). Run them on the card with

    JAX_PLATFORMS=cuda python -m pytest -m chip tests/

Tolerances:
  * MultiGrid golden traces: byte-exact (the engine is integer).
  * Walker physics against the recorded Box2D traces: the hull, fall and
    joint envelopes of test_walker_box2d_parity.py, unchanged.
  * CarRacing against its recorded traces: track geometry, tile rewards and
    road-mask IoU with the bounds of test_carracing_box2d_parity.py.
  * Network forwards against the float64 numpy reference: f32 under
    ``default_matmul_precision('highest')`` to 1e-4 (relative, and absolute
    on the output's scale); at the program's default precision — bf16
    compute for the MultiGrid and CarRacing students and the teacher, which
    --bf16 auto selects on the GPU, and f32 dots that may run in TF32
    (10-bit mantissa) for the rest — to 5e-2 for bf16 and 1e-2 for TF32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dcd_isaac_tpu.envs.multigrid import AdversarialMultiGrid, MultiGridParams

import test_carracing_box2d_parity as cr
import test_multigrid_golden_trace as mg
import test_nn_layers as layers
import test_walker_box2d_parity as wk

pytestmark = pytest.mark.chip

TF32_TOL = 1e-2


@pytest.fixture(scope='module')
def mg_data():
    return np.load(mg.FIXTURE)


@pytest.fixture(scope='module')
def wk_data():
    return np.load(wk.FIXTURE)


@pytest.fixture(scope='module')
def cr_data():
    return np.load(cr.FIX)


def construct_jitted(data, name):
    """mg.construct with the teacher's step compiled once (eager op-by-op
    dispatch compiles every primitive separately on the GPU)."""
    g = lambda k: data[f'{name}/{k}']
    env = AdversarialMultiGrid(MultiGridParams(**mg.SCENARIOS[name]))
    rng = jax.random.PRNGKey(0)
    state, _ = jax.jit(env.reset)(rng)
    step = jax.jit(env.step_adversary)
    done = False
    for a in g('adv_actions'):
        state, _, done = step(state, jnp.int32(int(a)), rng)
    assert bool(done)
    return env, state, g


@pytest.mark.parametrize('name', list(mg.SCENARIOS))
def test_multigrid_golden_trace_exact(mg_data, name, monkeypatch):
    built = construct_jitted(mg_data, name)
    monkeypatch.setattr(mg, 'construct', lambda data, n: built)
    mg.TestConstruction().test_grid_encoding_exact(mg_data, name)
    mg.TestConstruction().test_placement_and_metrics(mg_data, name)
    mg.TestStudentTrace().test_obs_reward_done_exact(mg_data, name)


@pytest.mark.parametrize('name', wk.TRACES)
def test_walker_box2d_envelopes(wk_data, name, monkeypatch):
    replayed = wk.replay(wk_data, name)     # once, for all three checks
    monkeypatch.setattr(wk, 'replay', lambda data, n: replayed)
    wk.TestHullTrajectory().test_short_horizon_position(wk_data, name)
    wk.TestHullTrajectory().test_fall_timing_envelope(wk_data, name)
    if name in ('flat_gait', 'flat_random', 'rough_gait', 'box_step_gait',
                'box_wall_stand'):
        wk.TestJointTracking().test_joint_angle_correlation(wk_data, name)


@pytest.mark.parametrize('name', cr.CTRL)
def test_carracing_track_geometry(cr_data, name):
    cr.TestTrackGeometry().test_points_betas_offsets_match(cr_data, name)
    cr.TestTrackGeometry().test_road_membership_matches_tile_quads(
        cr_data, name)


def test_carracing_tile_rewards(cr_data):
    t = cr.TestTileRewards()
    for name in ('bez7_open', 'bez11_open'):
        t.test_open_loop_reward_sequence(cr_data, name)
    for name in cr.CTRL:
        t.test_closed_loop_driving_parity(cr_data, name)


def test_carracing_road_mask_iou(cr_data):
    cr.TestRenderRoadMask().test_road_mask_iou_vs_reference_polys(
        cr_data, 'bez7_ctrl')


@pytest.mark.parametrize('name', layers.NETWORKS)
def test_network_f32_highest(name):
    with jax.default_matmul_precision('highest'):
        layers.check_network(name, jnp.float32, layers.F32_TOL)


@pytest.mark.parametrize('name', layers.NETWORKS)
def test_network_default_precision(name):
    if name in layers.BF16_NETWORKS:
        layers.check_network(name, jnp.bfloat16, layers.BF16_TOL)
    else:
        layers.check_network(name, jnp.float32, TF32_TOL)


def test_runs_on_gpu():
    assert jax.devices()[0].platform == 'gpu'
    x = jnp.ones(4)
    assert x.devices() == {jax.devices()[0]}
