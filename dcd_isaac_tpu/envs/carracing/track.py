"""Track geometry + on-device rasterization for CarRacing.

Replaces Box2D static sensor tiles + pyglet GL rendering (reference
car_racing_bezier.py:284-426, :701-800) with dense geometry arrays and a
pure-jnp rasterizer: road membership, tile indices and the 96×96×3 pixel
observation are all computed from the centerline polyline by
nearest-segment queries — fully jit/vmap-compatible, so the pixel obs stays
inside the training loop on device.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from ...utils import struct

# Constants (car_racing_bezier.py:39-61)
STATE_W, STATE_H = 96, 96
WINDOW_W, WINDOW_H = 1000, 800
SCALE = 6.0
TRACK_RAD = 900 / SCALE
PLAYFIELD = 2000 / SCALE
FPS = 50
ZOOM = 2.7
TRACK_WIDTH = 40 / SCALE
BORDER = 8 / SCALE
BORDER_MIN_COUNT = 4
ROAD_COLOR = np.array([0.4, 0.4, 0.4], np.float32)
GRASS_BASE = np.array([0.4, 0.8, 0.4], np.float32)
GRASS_PATCH = np.array([0.4, 0.9, 0.4], np.float32)


@struct.dataclass
class Track:
    points: jnp.ndarray    # (P, 2) centered centerline
    beta: jnp.ndarray      # (P,) normal angle per point (pi/2 + alpha)
    border: jnp.ndarray    # (P,) bool — red/white border on this tile
    valid: jnp.ndarray     # (P,) bool — active points (padding mask)
    n_points: jnp.ndarray  # () int32
    offset: jnp.ndarray    # (2,) world→centered offset (bbox center)

    @property
    def capacity(self) -> int:
        return self.points.shape[0]


def build_track(curve: jnp.ndarray, valid=None) -> Track:
    """Curve points (P, 2) → Track with betas, centering and border flags.

    Reference _create_track_bezier (car_racing_bezier.py:305-404).
    """
    P = curve.shape[0]
    if valid is None:
        valid = jnp.ones((P,), bool)

    # consecutive segment angles (wrap via roll on valid range is
    # approximated by the padded roll — padding repeats the last point)
    nxt = jnp.roll(curve, -1, axis=0)
    d = nxt - curve
    alpha = jnp.arctan2(d[:, 1], d[:, 0])
    beta = jnp.pi / 2 + alpha

    # The reference skips zero-length steps when building track entries
    # (car_racing_bezier.py:311-318 `if dx == dy == 0: continue`, plus the
    # closing duplicate excluded by `points[:-1]`).  Bézier segment
    # endpoints coincide exactly with the next segment's start, so a
    # 12-segment × 40-point curve yields 468 tiles, not 480; counting the
    # duplicates would inflate tile_visited_count and shrink the 1000/N
    # per-tile reward.
    valid = valid & ~(d == 0).all(-1)
    n = valid.sum()

    # center offset from bbox of valid points
    big = 1e9
    xs = jnp.where(valid, curve[:, 0], big)
    ys = jnp.where(valid, curve[:, 1], big)
    min_x = xs.min()
    min_y = ys.min()
    xs = jnp.where(valid, curve[:, 0], -big)
    ys = jnp.where(valid, curve[:, 1], -big)
    max_x = xs.max()
    max_y = ys.max()
    offset = jnp.stack([min_x + (max_x - min_x) / 2,
                        min_y + (max_y - min_y) / 2])
    points = curve - offset

    # border detection (car_racing_bezier.py:336-357)
    dbeta = jnp.abs(jnp.roll(beta, -1) - beta)
    mean_abs_dbeta = jnp.where(valid, dbeta, 0).sum() / jnp.maximum(n, 1)
    good = jnp.ones((P,), bool)
    oneside = jnp.zeros((P,))
    for neg in range(BORDER_MIN_COUNT):
        b1 = jnp.roll(beta, neg)       # beta[i - neg]
        b2 = jnp.roll(beta, neg + 1)   # beta[i - neg - 1]
        good = good & (jnp.abs(b1 - b2) > mean_abs_dbeta)
        oneside = oneside + jnp.sign(b1 - b2)
    border = good & (jnp.abs(oneside) == BORDER_MIN_COUNT)
    for neg in range(BORDER_MIN_COUNT):
        border = border | jnp.roll(border, -neg)
    border = border & valid

    return Track(points=points, beta=beta, border=border, valid=valid,
                 n_points=n.astype(jnp.int32), offset=offset)


def nearest_tile(track: Track, q: jnp.ndarray):
    """Nearest centerline point index + distance for query points (..., 2).

    Expanded form |q|² + |p|² − 2 q·p so the cross term is a matmul: for
    the 96×96-pixel render this turns the (pixels × P) pair-distance
    tensor's inner work into one (pixels, 2) × (2, P) matmul
    instead of a broadcast subtract/square, and min/argmin consume the
    fused result directly (no gather pass).  f32 cancellation error here
    is ≤ ~1e-2 world-units² against a road threshold of TRACK_WIDTH² ≈ 44
    — pixel classification is unchanged (IoU-validated tests).
    """
    q2 = (q ** 2).sum(-1)
    p2 = (track.points ** 2).sum(-1)
    # HIGHEST precision: on the GPU an f32 matmul at default precision may
    # run in TF32, whose 10-bit mantissa (~2^-11 relative rounding) on
    # cross terms of magnitude ~1e5 would inject tens to hundreds of
    # units^2 into d2 — past the 44-unit^2 road threshold. Full-f32 passes
    # keep the stated ~1e-2 bound.
    qp = jnp.matmul(q, track.points.T, precision=jax.lax.Precision.HIGHEST)
    d2 = q2[..., None] + p2 - 2.0 * qp
    d2 = jnp.where(track.valid, d2, jnp.inf)
    idx = jnp.argmin(d2, axis=-1)
    d2min = jnp.min(d2, axis=-1)
    return idx, jnp.sqrt(jnp.maximum(d2min, 0.0))


def _tile_frame(track: Track, idx: jnp.ndarray, q: jnp.ndarray):
    """Distance along the tile normal and tangent for classification."""
    p = track.points[idx]
    beta = track.beta[idx]
    nrm = jnp.stack([jnp.cos(beta), jnp.sin(beta)], -1)
    rel = q - p
    dist_n = (rel * nrm).sum(-1)       # signed lateral offset
    return dist_n


def on_road(track: Track, q: jnp.ndarray):
    """Road membership for points (..., 2) → (bool, tile_idx)."""
    idx, dist = nearest_tile(track, q)
    return dist <= TRACK_WIDTH, idx


def render_frame(track: Track, car_pos: jnp.ndarray, car_angle: jnp.ndarray,
                 car_vel: jnp.ndarray, car_angvel: jnp.ndarray,
                 wheel_omega: jnp.ndarray, steer: jnp.ndarray,
                 t: jnp.ndarray) -> jnp.ndarray:
    """96×96×3 uint8 state-pixels frame (reference render(), :701-800).

    Camera follows the car: zoom ramp over the first second, car drawn at
    (W/2, H/4) of the window, view rotated so the car faces up.  The window
    →state viewport scaling (96/1000, 96/800) is reproduced, including its
    anisotropy.
    """
    zoom = 0.1 * SCALE * jnp.maximum(1 - t, 0) + ZOOM * SCALE * jnp.minimum(
        t, 1)
    sx = zoom * STATE_W / WINDOW_W
    sy = zoom * STATE_H / WINDOW_H

    # pixel grid: i = column (x right), j = row (top down)
    i = jnp.arange(STATE_W, dtype=jnp.float32)
    j = jnp.arange(STATE_H, dtype=jnp.float32)
    px, py = jnp.meshgrid(i, j, indexing='xy')          # (H, W)
    # screen coords with origin at car anchor, y up
    ex = (px - STATE_W / 2) / sx
    ey = ((STATE_H - 1 - py) - STATE_H / 4) / sy
    # rotate by car angle (camera angle = car angle; car faces up on screen)
    # gym car-local frame: +y is forward, +x is right; world directions
    # right = (cos a, sin a), forward = (-sin a, cos a).  Screen right maps
    # to local +x, screen up to local +y.
    ca, sa = jnp.cos(car_angle), jnp.sin(car_angle)
    wx = car_pos[0] + ex * ca + ey * (-sa)
    wy = car_pos[1] + ex * sa + ey * ca
    q = jnp.stack([wx, wy], -1)                          # (H, W, 2)

    idx, dist = nearest_tile(track, q)
    is_road = dist <= TRACK_WIDTH
    shade = 0.01 * (idx % 3).astype(jnp.float32)
    road_rgb = ROAD_COLOR + shade[..., None]

    # borders: outer side of hard turns, width BORDER beyond the track edge
    beta_i = track.beta[idx]
    beta_prev = track.beta[(idx - 1) % track.capacity]
    side = jnp.sign(beta_prev - beta_i)
    lat = _tile_frame(track, idx, q)
    in_border = (track.border[idx]
                 & (dist > TRACK_WIDTH)
                 & (dist <= TRACK_WIDTH + BORDER)
                 & (jnp.sign(lat) == side))
    border_white = (idx % 2) == 0
    border_rgb = jnp.where(
        border_white[..., None],
        jnp.ones(3),
        jnp.array([1.0, 0.0, 0.0]))

    # grass checker (reference render: 20-unit squares, k=playfield/20)
    checker = ((jnp.floor(wx / 20) + jnp.floor(wy / 20)) % 2) == 0
    grass_rgb = jnp.where(checker[..., None], GRASS_PATCH, GRASS_BASE)

    img = jnp.where(is_road[..., None], road_rgb, grass_rgb)
    img = jnp.where(in_border[..., None], border_rgb, img)

    # car sprite: fixed screen-space rectangle (car always centered, facing
    # up).  Hull ~ (3.3 x 5.0 units): local x in [-1, 1], y in [-2.6, 2.4].
    lx = ex  # local right
    ly = ey  # local forward
    hull = (jnp.abs(lx) < 1.0) & (ly > -2.6) & (ly < 2.6)
    wheels = ((jnp.abs(jnp.abs(lx) - 1.1) < 0.30)
              & ((jnp.abs(ly - 1.6) < 0.55) | (jnp.abs(ly + 1.64) < 0.55)))
    img = jnp.where(hull[..., None], jnp.array([0.8, 0.0, 0.0]), img)
    img = jnp.where(wheels[..., None], jnp.zeros(3), img)

    # indicator bar (render_indicators): bottom 5*h/40 ≈ 12 rows black with
    # value bars: speed (white), 4 wheel omegas (blue/red), steering (green)
    H = STATE_H
    bar_h = 5 * H // 40
    row = py  # (H, W)
    in_bar = row >= (H - bar_h)
    img = jnp.where(in_bar[..., None], jnp.zeros(3), img)

    speed = jnp.sqrt((car_vel ** 2).sum())

    def vbar(img, x0, value, color, scale=1.0):
        h = jnp.clip(jnp.abs(value) * scale, 0, 1) * bar_h
        on = (in_bar & (px >= x0) & (px < x0 + 2)
              & (row >= H - h))
        return jnp.where(on[..., None], color, img)

    img = vbar(img, 5.0, speed, jnp.ones(3), 0.02)
    img = vbar(img, 10.0, wheel_omega[0], jnp.array([0.0, 0.0, 1.0]), 0.01)
    img = vbar(img, 13.0, wheel_omega[1], jnp.array([0.0, 0.0, 1.0]), 0.01)
    img = vbar(img, 16.0, wheel_omega[2], jnp.array([0.2, 0.0, 1.0]), 0.01)
    img = vbar(img, 19.0, wheel_omega[3], jnp.array([0.2, 0.0, 1.0]), 0.01)
    img = vbar(img, 24.0, steer, jnp.array([0.0, 1.0, 0.0]), 2.0)
    img = vbar(img, 29.0, car_angvel, jnp.array([1.0, 0.0, 0.0]), 0.3)

    return (jnp.clip(img, 0, 1) * 255).astype(jnp.uint8)
