"""CarRacing environment core with folded wrapper semantics.

Combines reference car_racing_bezier.py (tile-visit rewards, termination)
with CarRacingWrapper (car_racing_wrappers.py:16-205: ×8 action repeat,
reward shaping with +100 finish bonus and off-road penalty, early
termination when the 100-step average shaped reward ≤ -0.1, crop/grayscale/
scale preprocessing, ×4 frame stack) into one jitted step.

Deviation (documented): the wrapper's green-pixel penalty (mean green
channel > 185) is replaced by an equivalent hull-off-road test — rendering
every inner repeat frame just to detect grass would cost 8 rasterizations
per control step; off-road ⇔ green view for this camera.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from .dynamics import CarState, car_step, init_car, wheel_positions
from .track import (
    FPS, PLAYFIELD, STATE_H, STATE_W, TRACK_WIDTH, Track, build_track,
    nearest_tile, on_road, render_frame,
)
from ...utils import struct


@dataclasses.dataclass(frozen=True)
class CarRacingConfig:
    track_capacity: int = 480        # bezier: 12 segments × 40 samples
    max_inner_steps: int = 1000      # TimeLimit (registration)
    num_action_repeat: int = 8
    frame_stack: int = 4
    grayscale: bool = False
    crop: bool = False
    reward_shaping: bool = True
    early_termination: bool = True
    timelimit_bonus: bool = True
    n_control_points: int = 12
    playfield: float = PLAYFIELD
    # Sparse-reward goal bins (REPAIRED CarRacing; reference
    # car_racing_bezier.py:107-129, :683-691).  When active, reward_shaping
    # is forced off upstream (util/__init__.py:164).
    sparse_rewards: bool = False
    num_goal_bins: int = 24
    clip_reward: float | None = None

    @property
    def obs_hw(self):
        return (84, 84) if self.crop else (STATE_H, STATE_W)

    @property
    def obs_channels(self):
        c = 1 if self.grayscale else 3
        return c * self.frame_stack


@struct.dataclass
class CarRacingState:
    car: CarState
    track: Track
    visited: jnp.ndarray        # (P,) bool
    tile_visited_count: jnp.ndarray
    reward_total: jnp.ndarray   # env cumulative (reference self.reward)
    prev_reward: jnp.ndarray
    t: jnp.ndarray              # sim time (s)
    inner_steps: jnp.ndarray    # () int32
    reward_history: jnp.ndarray  # (100,) shaped-reward ring buffer
    hist_ptr: jnp.ndarray
    frames: jnp.ndarray         # (H, W, C*stack) float32 stacked obs
    done_latch: jnp.ndarray     # () bool
    # sparse-reward goal state (dense mode: goal_bin = -1)
    goal_bin: jnp.ndarray       # () int32
    goal_reached: jnp.ndarray   # () bool
    sparse_accum: jnp.ndarray   # () float32 hidden accumulated reward
    # level definition (encoded) + teacher design-phase scratch
    control_points: jnp.ndarray  # (27,) encoded level
    level_seed: jnp.ndarray
    adv_cps: jnp.ndarray         # (12, 2) placed control points (playfield)
    adv_n: jnp.ndarray           # () int32 number placed
    adv_step_count: jnp.ndarray  # () int32
    adv_start_alpha: jnp.ndarray  # () float32; -1 = unset (start index 0)
    adv_goal_bin: jnp.ndarray    # () int32; num_goal_bins until chosen


def _preprocess(cfg: CarRacingConfig, frame_u8: jnp.ndarray) -> jnp.ndarray:
    """Crop/grayscale/scale (car_racing_wrappers.py:59-70)."""
    obs = frame_u8.astype(jnp.float32)
    if cfg.crop:
        obs = obs[:-12, 6:-6]
    if cfg.grayscale:
        obs = (obs * jnp.array([0.299, 0.587, 0.114])).sum(
            -1, keepdims=True)
    return obs / 128.0 - 1.0


def _render_obs(cfg: CarRacingConfig, car: CarState, track: Track,
                t: jnp.ndarray) -> jnp.ndarray:
    frame = render_frame(
        track, car.pos, car.angle, car.vel, car.angvel, car.wheel_omega,
        car.steer_angle, t)
    return _preprocess(cfg, frame)


def _visit_tiles(track: Track, visited: jnp.ndarray, car: CarState):
    """Wheel-tile sensor contacts (FrictionDetector,
    car_racing_bezier.py:64-129) → (visited, newly_visited_count,
    new-tile mask (P,), wheels_on_road (4,))."""
    wp = wheel_positions(car)
    road, idx = on_road(track, wp)
    P = track.capacity
    hits = jnp.zeros((P,), bool).at[idx].max(road)
    new = hits & ~visited
    return visited | new, new.sum(), new, road


def _goal_eval(track: Track, new: jnp.ndarray, goal_bin: jnp.ndarray,
               num_goal_bins: int):
    """Sparse-reward goal-bin test over newly visited tiles
    (FrictionDetector._eval_tile_index, car_racing_bezier.py:112-129).

    A tile at index i maps to bin floor((track_len - i) / goal_step); the
    goal counts as reached when a newly visited tile lands in the goal bin,
    except within MIN_DISTANCE_TO_GO=10 tiles of the start/finish line
    (bins 0 and num_goal_bins-1 edge rules).
    """
    n = track.n_points.astype(jnp.float32)
    goal_step = n / num_goal_bins
    idx = jnp.arange(track.capacity, dtype=jnp.float32)
    distance = n - idx
    tile_bin = jnp.floor(distance / jnp.maximum(goal_step, 1e-6))
    gb = goal_bin.astype(jnp.float32)
    force_false = (((goal_bin == 0) & (distance < 10))
                   | ((goal_bin == num_goal_bins - 1) & (idx < 10)))
    reach = (tile_bin == gb) & ~force_false & track.valid
    return (new & reach).any()


def make_carracing_core(cfg: CarRacingConfig):
    """Bundle of pure env functions closed over the static config."""

    def fresh_state(track: Track, control_points, level_seed,
                    start_idx=None,
                    goal_bin=None) -> Tuple[CarRacingState, jnp.ndarray]:
        if start_idx is None:
            start_idx = jnp.int32(0)
        if goal_bin is None:
            goal_bin = jnp.int32(-1)
        beta0 = track.beta[start_idx]
        p0 = track.points[start_idx]
        car = init_car(beta0, p0[0], p0[1])
        H, W = cfg.obs_hw
        state = CarRacingState(
            car=car,
            track=track,
            visited=jnp.zeros((track.capacity,), bool),
            tile_visited_count=jnp.int32(0),
            reward_total=jnp.float32(0.0),
            prev_reward=jnp.float32(0.0),
            t=jnp.float32(0.0),
            inner_steps=jnp.int32(0),
            reward_history=jnp.zeros((100,)),
            hist_ptr=jnp.int32(0),
            frames=jnp.zeros((H, W, cfg.obs_channels)),
            done_latch=jnp.bool_(False),
            goal_bin=jnp.asarray(goal_bin, jnp.int32),
            goal_reached=jnp.bool_(False),
            sparse_accum=jnp.float32(0.0),
            control_points=control_points,
            level_seed=level_seed,
            adv_cps=jnp.zeros((12, 2)),
            adv_n=jnp.int32(0),
            adv_step_count=jnp.int32(0),
            adv_start_alpha=jnp.float32(-1.0),
            adv_goal_bin=jnp.int32(cfg.num_goal_bins),
        )
        # initial frame, replicated across the stack (wrapper _reset_stack)
        obs0 = _render_obs(cfg, car, track, state.t)
        frames = jnp.concatenate([obs0] * cfg.frame_stack, axis=-1)
        state = state.replace(frames=frames)
        return state, frames

    def step(state: CarRacingState, action: jnp.ndarray, rng=None):
        """Wrapper-level step: ×8 inner physics steps + stack update.

        action = (steer, gas, brake) with steer ∈ [-1, 1]; note the
        reference negates steer (car_racing_bezier.py:649).
        """
        steer = -action[0]
        gas = action[1]
        brake = action[2]

        def inner(carry, _):
            (car, visited, count, reward_total, prev_reward, t, steps,
             hist, ptr, done, goal_reached, sparse_accum) = carry

            wp_road = on_road(state.track, wheel_positions(car))[0]
            car2 = car_step(car, steer, gas, brake, wp_road)
            visited2, n_new, new_tiles, _ = _visit_tiles(
                state.track, visited, car2)
            t2 = t + 1.0 / FPS
            steps2 = steps + 1

            # reference step(): -0.1 per frame + 1000/N per new tile
            n_track = jnp.maximum(state.track.n_points, 1).astype(
                jnp.float32)
            reward_total2 = (reward_total - 0.1
                             + 1000.0 / n_track * n_new)
            step_reward = reward_total2 - prev_reward

            all_visited = visited2.sum() >= state.track.n_points
            off_field = (jnp.abs(car2.pos) > cfg.playfield).any()
            die = all_visited | off_field
            step_reward = jnp.where(off_field, -100.0, step_reward)

            # Sparse-reward reveal (car_racing_bezier.py:683-691): rewards
            # accumulate hidden; reaching the goal bin reveals the sum and
            # ends the episode.
            if cfg.sparse_rewards:
                reached_now = _goal_eval(
                    state.track, new_tiles, state.goal_bin,
                    cfg.num_goal_bins)
                goal_reached2 = goal_reached | reached_now
                sparse_accum2 = sparse_accum + step_reward
                step_reward = jnp.where(goal_reached2, sparse_accum2, 0.0)
                sparse_accum2 = jnp.where(goal_reached2, 0.0, sparse_accum2)
                die = die | goal_reached2
            else:
                goal_reached2, sparse_accum2 = goal_reached, sparse_accum

            if cfg.clip_reward is not None:
                step_reward = jnp.clip(
                    step_reward, -cfg.clip_reward, cfg.clip_reward)

            # reward shaping (wrapper): +100 on die (timelimit bonus),
            # -0.05 when off road (≈ green-view penalty)
            shaped = step_reward
            if cfg.reward_shaping:
                shaped = shaped + jnp.where(
                    die & ~off_field, 100.0, 0.0)
                hull_off = ~on_road(state.track, car2.pos[None])[0][0]
                shaped = shaped - jnp.where(hull_off, 0.05, 0.0)

            # early termination ring buffer
            if cfg.reward_shaping and cfg.early_termination:
                hist2 = hist.at[ptr % 100].set(
                    jnp.where(done, hist[ptr % 100], shaped))
                ptr2 = jnp.where(done, ptr, ptr + 1)
                early = hist2.mean() <= -0.1
            else:
                hist2, ptr2 = hist, ptr
                early = jnp.bool_(False)

            new_done = done | die | early
            # freeze dynamics after done within the repeat loop
            sel = lambda a, b: jax.tree.map(
                lambda x, y: jnp.where(done, x, y), a, b)
            car2 = sel(car, car2)
            visited2 = jnp.where(done, visited, visited2)
            reward_total2 = jnp.where(done, reward_total, reward_total2)
            shaped = jnp.where(done, 0.0, shaped)
            prev2 = jnp.where(done, prev_reward, reward_total2)
            t2 = jnp.where(done, t, t2)
            steps2 = jnp.where(done, steps, steps2)
            goal_reached2 = jnp.where(done, goal_reached, goal_reached2)
            sparse_accum2 = jnp.where(done, sparse_accum, sparse_accum2)

            return ((car2, visited2, count + jnp.where(done, 0, n_new),
                     reward_total2, prev2, t2, steps2, hist2, ptr2,
                     new_done, goal_reached2, sparse_accum2), shaped)

        carry0 = (state.car, state.visited, state.tile_visited_count,
                  state.reward_total, state.prev_reward, state.t,
                  state.inner_steps, state.reward_history, state.hist_ptr,
                  state.done_latch, state.goal_reached, state.sparse_accum)
        # fully unroll the fixed-length repeat loop: the 8 substeps are
        # tiny launch-bound kernels; unrolling lets XLA fuse across them
        carry, shaped_rewards = jax.lax.scan(
            inner, carry0, None, length=cfg.num_action_repeat,
            unroll=cfg.num_action_repeat)
        (car, visited, count, reward_total, prev_reward, t, steps, hist,
         ptr, done, goal_reached, sparse_accum) = carry

        total_reward = shaped_rewards.sum()

        # TimeLimit on inner steps (registration max_episode_steps=1000)
        timeout = steps >= cfg.max_inner_steps
        done_out = done | timeout
        truncated = timeout & ~done

        obs = _render_obs(cfg, car, state.track, t)
        c = obs.shape[-1]
        frames = jnp.concatenate(
            [state.frames[..., c:], obs], axis=-1)

        state = state.replace(
            car=car, visited=visited, tile_visited_count=count,
            reward_total=reward_total, prev_reward=prev_reward, t=t,
            inner_steps=steps, reward_history=hist, hist_ptr=ptr,
            frames=frames, done_latch=done,
            goal_reached=goal_reached, sparse_accum=sparse_accum,
        )
        info = {'truncated': truncated}
        return state, frames, total_reward, done_out, info

    return fresh_state, step
