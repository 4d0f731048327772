"""POET-style parameterized terrain generation, pure JAX.

Reference walker_env.py:249-395 (_generate_terrain): a state machine over
GRASS/STUMP/STAIRS/PIT sections driven by an 8-d level-parameter vector.
Re-designed as a ``lax.scan`` over the 200 terrain steps emitting a
heightfield plus a fixed-size buffer of axis-aligned obstacle boxes (stumps,
stair treads, pit walls) — the dense static-geometry form consumed by the
JAX contact solver and lidar instead of Box2D static bodies.

Feature-enable thresholds replicate reference adversarial.py get_config
(:232-260): stumps off when stump_height_hi < 0.2, pits off when
pit_gap_hi < 0.8, stairs off when stair_height_hi < 0.2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .physics import (
    MAX_BOXES, TERRAIN_GRASS, TERRAIN_HEIGHT, TERRAIN_LENGTH, TERRAIN_STARTPAD,
    TERRAIN_STEP, Terrain, SCALE,
)
from ...utils import struct

# Fixed sub-ranges (adversarial.py:78-81): randint collapses these to
# constants: stump_width=1, stump_float=0, stair_width=4.
STUMP_WIDTH = 1.0
STUMP_FLOAT = 0.0
STAIR_WIDTH = 4
MAX_STAIR_STEPS = 9

GRASS, STUMP, STAIRS, PIT = 0, 1, 2, 3


def generate_terrain(params: jnp.ndarray, rng: jax.Array) -> Terrain:
    """8-param level vector + rng → Terrain.

    params = [roughness, pit_lo, pit_hi, stump_lo, stump_hi,
              stair_lo, stair_hi, stair_steps]
    """
    roughness = params[0]
    pit_lo = jnp.minimum(params[1], params[2])
    pit_hi = jnp.maximum(params[1], params[2])
    stump_lo = jnp.minimum(params[3], params[4])
    stump_hi = jnp.maximum(params[3], params[4])
    stair_lo = jnp.minimum(params[5], params[6])
    stair_hi = jnp.maximum(params[5], params[6])
    stair_steps_max = jnp.round(params[7]).astype(jnp.int32)

    stump_on = stump_hi >= 0.2
    pit_on = pit_hi >= 0.8
    stairs_on = stair_hi >= 0.2
    hardcore = stump_on | pit_on | stairs_on

    # Enabled-state list in reference order (STUMP, STAIRS, PIT): the state
    # machine samples uniformly among enabled features.
    feat_ids = jnp.array([STUMP, STAIRS, PIT])
    feat_on = jnp.array([0, 0, 0], jnp.bool_)
    feat_on = feat_on.at[0].set(stump_on).at[1].set(stairs_on).at[2].set(
        pit_on)

    def sample_feature(rng):
        logits = jnp.where(feat_on, 0.0, -jnp.inf)
        i = jax.random.categorical(rng, logits)
        return jnp.where(hardcore, feat_ids[i], GRASS)

    class C:  # scan carry fields by index
        pass

    init = dict(
        state=jnp.int32(GRASS),
        velocity=jnp.float32(0.0),
        y=jnp.float32(TERRAIN_HEIGHT),
        counter=jnp.int32(TERRAIN_STARTPAD),
        oneshot=jnp.bool_(False),
        original_y=jnp.float32(0.0),
        pit_diff=jnp.float32(0.0),
        stair_height=jnp.float32(0.0),
        stair_slope=jnp.float32(1.0),
        stair_steps=jnp.int32(0),
        boxes=jnp.zeros((MAX_BOXES, 4)),
        n_boxes=jnp.int32(0),
        x_shift=jnp.float32(0.0),   # pit_diff x adjustment bookkeeping
        rng=rng,
    )

    def emit_box(boxes, n, x0, y0, x1, y1, cond):
        idx = jnp.minimum(n, MAX_BOXES - 1)
        box = jnp.stack([jnp.minimum(x0, x1), jnp.minimum(y0, y1),
                         jnp.maximum(x0, x1), jnp.maximum(y0, y1)])
        boxes = jnp.where(cond, boxes.at[idx].set(box), boxes)
        n = n + cond.astype(jnp.int32)
        return boxes, n

    def step(c, i):
        x = i.astype(jnp.float32) * TERRAIN_STEP
        rng, r1, r2, r3, r4, r5 = jax.random.split(c['rng'], 6)
        state, oneshot = c['state'], c['oneshot']
        y = c['y']
        velocity = c['velocity']
        boxes, n_boxes = c['boxes'], c['n_boxes']
        counter = c['counter']
        original_y, pit_diff = c['original_y'], c['pit_diff']
        st_h, st_slope, st_steps = (
            c['stair_height'], c['stair_slope'], c['stair_steps'])
        x_shift_prev = c['x_shift']
        x_shift = jnp.float32(0.0)

        # --- GRASS ------------------------------------------------------
        is_grass = (state == GRASS) & ~oneshot
        v_new = 0.8 * velocity + 0.01 * jnp.sign(TERRAIN_HEIGHT - y)
        v_new = v_new + jnp.where(
            i > TERRAIN_STARTPAD,
            jax.random.uniform(r1, minval=-1.0, maxval=1.0) / SCALE, 0.0)
        velocity = jnp.where(is_grass, v_new, velocity)
        y = jnp.where(is_grass, y + roughness * velocity, y)

        # --- PIT oneshot ------------------------------------------------
        is_pit_one = (state == PIT) & oneshot
        pit_gap = 1.0 + jax.random.uniform(r2, minval=pit_lo, maxval=pit_hi)
        new_counter = jnp.ceil(pit_gap).astype(jnp.int32)
        pd = new_counter.astype(jnp.float32) - pit_gap
        boxes, n_boxes = emit_box(
            boxes, n_boxes, x, y - 4 * TERRAIN_STEP, x + TERRAIN_STEP, y,
            is_pit_one)
        boxes, n_boxes = emit_box(
            boxes, n_boxes, x + TERRAIN_STEP * pit_gap, y - 4 * TERRAIN_STEP,
            x + TERRAIN_STEP * (1 + pit_gap), y, is_pit_one)
        counter = jnp.where(is_pit_one, new_counter + 2, counter)
        pit_diff = jnp.where(is_pit_one, pd, pit_diff)
        original_y = jnp.where(is_pit_one, y, original_y)

        # --- PIT continue -----------------------------------------------
        is_pit = (state == PIT) & ~oneshot
        y = jnp.where(is_pit,
                      jnp.where(counter > 1,
                                original_y - 4 * TERRAIN_STEP, original_y),
                      y)
        # at counter==1 the x of this point shifts back by pit_diff*STEP
        x_shift = jnp.where(is_pit & (counter == 1),
                            -pit_diff * TERRAIN_STEP, 0.0)
        pit_diff = jnp.where(is_pit & (counter == 1), 0.0, pit_diff)

        # --- STUMP oneshot ----------------------------------------------
        is_stump = (state == STUMP) & oneshot
        stump_h = jax.random.uniform(r3, minval=stump_lo, maxval=stump_hi)
        boxes, n_boxes = emit_box(
            boxes, n_boxes,
            x, y + STUMP_FLOAT * TERRAIN_STEP,
            x + STUMP_WIDTH * TERRAIN_STEP,
            y + (stump_h + STUMP_FLOAT) * TERRAIN_STEP,
            is_stump)

        # --- STAIRS oneshot ---------------------------------------------
        is_stairs_one = (state == STAIRS) & oneshot
        sh = jax.random.uniform(r4, minval=stair_lo, maxval=stair_hi)
        slope = jnp.where(jax.random.uniform(r5) > 0.5, 1.0, -1.0)
        ss = jax.random.randint(
            r5, (), 0, jnp.maximum(stair_steps_max, 1))
        big = sh > 1e-2
        for s in range(MAX_STAIR_STEPS):
            cond = is_stairs_one & big & (s < ss)
            y_top = y + (s * sh * slope) * TERRAIN_STEP
            boxes, n_boxes = emit_box(
                boxes, n_boxes,
                x + (s * STAIR_WIDTH) * TERRAIN_STEP,
                y_top - sh * TERRAIN_STEP,
                x + ((1 + s) * STAIR_WIDTH) * TERRAIN_STEP,
                y_top,
                cond)
        counter = jnp.where(is_stairs_one & big, ss * STAIR_WIDTH + 1,
                            counter)
        st_h = jnp.where(is_stairs_one, sh, st_h)
        st_slope = jnp.where(is_stairs_one, slope, st_slope)
        st_steps = jnp.where(is_stairs_one, ss, st_steps)
        original_y = jnp.where(is_stairs_one, y, original_y)

        # --- STAIRS continue --------------------------------------------
        is_stairs = (state == STAIRS) & ~oneshot
        s_prog = (st_steps * STAIR_WIDTH - counter)
        n_step = s_prog // STAIR_WIDTH
        y_stairs = (original_y
                    + (n_step.astype(jnp.float32) * st_h * st_slope)
                    * TERRAIN_STEP
                    - jnp.where(st_slope < 0, st_h, 0.0) * TERRAIN_STEP)
        y = jnp.where(is_stairs, y_stairs, y)

        # --- emit height, advance counter/state -------------------------
        out_y = y
        counter = counter - 1
        rng, r6, r7 = jax.random.split(rng, 3)
        next_counter = jax.random.randint(
            r6, (), TERRAIN_GRASS // 2, TERRAIN_GRASS)
        rollover = counter == 0
        was_grass = state == GRASS
        new_state = jnp.where(
            rollover,
            jnp.where(was_grass & hardcore, sample_feature(r7),
                      jnp.int32(GRASS)),
            state)
        counter = jnp.where(rollover, next_counter, counter)
        oneshot = rollover

        new_c = dict(
            state=new_state, velocity=velocity, y=y, counter=counter,
            oneshot=oneshot, original_y=original_y, pit_diff=pit_diff,
            stair_height=st_h, stair_slope=st_slope, stair_steps=st_steps,
            boxes=boxes, n_boxes=jnp.minimum(n_boxes, MAX_BOXES),
            x_shift=x_shift, rng=rng)
        return new_c, (out_y, x_shift)

    final, (ys, x_shifts) = jax.lax.scan(
        step, init, jnp.arange(TERRAIN_LENGTH))

    xs = jnp.arange(TERRAIN_LENGTH, dtype=jnp.float32) * TERRAIN_STEP
    xs = xs + x_shifts
    return Terrain(xs=xs, ys=ys, boxes=final['boxes'],
                   n_boxes=final['n_boxes'])
