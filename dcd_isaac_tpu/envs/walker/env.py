"""BipedalWalker environment core (pure JAX).

Reference walker_env.py:411-588 (_reset_env + _step) on top of the JAX
physics engine: body placement, motor control mapping, 24-d proprioceptive
observation, shaping reward and termination.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import physics as ph
from .terrain import generate_terrain
from ...utils import struct


@struct.dataclass
class WalkerState:
    bodies: ph.Bodies
    terrain: ph.Terrain
    prev_shaping: jnp.ndarray       # ()
    game_over: jnp.ndarray          # () bool (hull ground contact)
    step_count: jnp.ndarray         # () int32
    lower_contact: jnp.ndarray      # (2,) bool
    joint_angle: jnp.ndarray        # (4,)
    joint_speed: jnp.ndarray        # (4,)
    # level definition
    level_params: jnp.ndarray       # (8,) float32
    level_seed: jnp.ndarray         # () uint32
    adv_step_count: jnp.ndarray     # () int32


def hull_origin(bodies: ph.Bodies) -> jnp.ndarray:
    """Box2D body position (polygon local origin), from centroid pos."""
    R = ph.rot(bodies.angle[0])
    return bodies.pos[0] - jnp.matmul(
        R, jnp.asarray(ph.HULL_CENTROID), precision=ph.HIGHEST)


def place_walker(rng: jax.Array) -> ph.Bodies:
    """Initial body placement (walker_env.py:427-486)."""
    init_x = ph.TERRAIN_STEP * ph.TERRAIN_STARTPAD / 2
    init_y = ph.TERRAIN_HEIGHT + 2 * ph.LEG_H
    hull_pos = jnp.array([init_x, init_y]) + jnp.asarray(ph.HULL_CENTROID)
    leg_y = init_y - ph.LEG_H / 2 - ph.LEG_DOWN
    low_y = init_y - ph.LEG_H * 3 / 2 - ph.LEG_DOWN
    pos = jnp.stack([
        hull_pos,
        jnp.array([init_x, leg_y]), jnp.array([init_x, low_y]),
        jnp.array([init_x, leg_y]), jnp.array([init_x, low_y])])
    angle = jnp.array([0.0, -0.05, -0.05, 0.05, 0.05])
    vel = jnp.zeros((5, 2))
    # initial random nudge: ApplyForceToCenter(U(-5, 5), 0) for one step
    fx = jax.random.uniform(
        rng, minval=-ph.INITIAL_RANDOM, maxval=ph.INITIAL_RANDOM)
    vel = vel.at[0, 0].set(fx / ph.BODY_MASS[0] * ph.DT)
    return ph.Bodies(pos=pos, angle=angle, vel=vel,
                     angvel=jnp.zeros(5))


def gen_walker_obs(state: WalkerState) -> jnp.ndarray:
    """24-d observation (walker_env.py:543-563)."""
    b = state.bodies
    lid = ph.lidar(b, state.terrain)
    vel = b.vel[0]
    obs = jnp.concatenate([
        jnp.stack([
            b.angle[0],
            2.0 * b.angvel[0] / ph.FPS,
            0.3 * vel[0] * (ph.VIEWPORT_W / ph.SCALE) / ph.FPS,
            0.3 * vel[1] * (ph.VIEWPORT_H / ph.SCALE) / ph.FPS,
            state.joint_angle[0],
            state.joint_speed[0] / ph.SPEED_HIP,
            state.joint_angle[1] + 1.0,
            state.joint_speed[1] / ph.SPEED_KNEE,
            state.lower_contact[0].astype(jnp.float32),
            state.joint_angle[2],
            state.joint_speed[2] / ph.SPEED_HIP,
            state.joint_angle[3] + 1.0,
            state.joint_speed[3] / ph.SPEED_KNEE,
            state.lower_contact[1].astype(jnp.float32),
        ]),
        lid,
    ])
    return obs


def reset_walker(level_params: jnp.ndarray, level_seed: jnp.ndarray,
                 max_steps: int) -> WalkerState:
    """Build terrain from (params, seed) and place the walker.

    Deterministic per (params, seed) — the reference re-seeds its RNG from
    level_seed on every reset_agent (adversarial.py:191-195).
    """
    rng = jax.random.PRNGKey(level_seed.astype(jnp.uint32))
    r_terrain, r_place = jax.random.split(rng)
    terrain = generate_terrain(level_params, r_terrain)
    return _reset_with_terrain(terrain, level_params, level_seed, r_place)


def reset_walker_from_terrain(terrain: ph.Terrain,
                              level_seed: jnp.ndarray) -> WalkerState:
    """Place the walker on an externally built terrain (genuine gym
    BipedalWalker-v3/Hardcore-v3 eval levels, gym_terrain.py)."""
    rng = jax.random.PRNGKey(level_seed.astype(jnp.uint32))
    _, r_place = jax.random.split(rng)
    return _reset_with_terrain(
        terrain, jnp.zeros(8), level_seed, r_place)


def _reset_with_terrain(terrain, level_params, level_seed, r_place):
    bodies = place_walker(r_place)
    state = WalkerState(
        bodies=bodies,
        terrain=terrain,
        prev_shaping=jnp.float32(0.0),
        game_over=jnp.bool_(False),
        step_count=jnp.int32(0),
        lower_contact=jnp.zeros(2, bool),
        joint_angle=jnp.array([0.05, 0.0, -0.05, 0.0]) * 0,
        joint_speed=jnp.zeros(4),
        level_params=level_params,
        level_seed=level_seed.astype(jnp.uint32),
        adv_step_count=jnp.int32(0),
    )
    # reference takes one zero-action step at reset (walker_env.py:498) and
    # uses its shaping as prev_shaping baseline
    state, _, _, _, _ = step_walker(state, jnp.zeros(4), first=True)
    return state


def step_walker(state: WalkerState, action: jnp.ndarray, first: bool = False):
    """→ (state, obs, reward, done, info).  walker_env.py:503-588."""
    motor_speed = jnp.array([
        ph.SPEED_HIP * jnp.sign(action[0]),
        ph.SPEED_KNEE * jnp.sign(action[1]),
        ph.SPEED_HIP * jnp.sign(action[2]),
        ph.SPEED_KNEE * jnp.sign(action[3]),
    ])
    motor_torque = ph.MOTORS_TORQUE * jnp.clip(jnp.abs(action), 0.0, 1.0)

    bodies, lower_contact, j_angle, j_speed, hull_contact = ph.physics_step(
        state.bodies, state.terrain, motor_speed, motor_torque)

    game_over = state.game_over | hull_contact
    state = state.replace(
        bodies=bodies, lower_contact=lower_contact, joint_angle=j_angle,
        joint_speed=j_speed, game_over=game_over,
        step_count=state.step_count + (0 if first else 1))

    pos = hull_origin(bodies)
    shaping = 130.0 * pos[0] / ph.SCALE - 5.0 * jnp.abs(bodies.angle[0])
    # reference: reward 0 on the reset step (prev_shaping is None there)
    reward = (jnp.float32(0.0) if first
              else shaping - state.prev_shaping)
    state = state.replace(prev_shaping=shaping)

    reward = reward - jnp.sum(
        0.00035 * ph.MOTORS_TORQUE * jnp.clip(jnp.abs(action), 0.0, 1.0))

    fell = game_over | (pos[0] < 0)
    finish = pos[0] > (
        (ph.TERRAIN_LENGTH - ph.TERRAIN_GRASS) * ph.TERRAIN_STEP)
    reward = jnp.where(fell, -100.0, reward)
    done = fell | finish

    obs = gen_walker_obs(state)
    return state, obs, reward, done, finish
