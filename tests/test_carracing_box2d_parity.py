"""CarRacing vs reference Box2D: recorded-trace parity (VERDICT r2 item 2).

Fixtures in tests/fixtures/carracing_box2d_traces.npz were recorded by
tools/record_carracing_traces.py from /root/reference/envs/box2d/
car_racing_bezier.py driving real Box2D (gym multi-body car_dynamics.Car,
FrictionDetector sensor tiles) under fixed control points and deterministic
actions.  Four surfaces are validated:

  (a) track geometry: identical curve/tile anchors from identical control
      points (car_racing_bezier.py:284-426);
  (b) tile-visit reward sequences within an envelope (FrictionDetector,
      car_racing_bezier.py:64-129);
  (c) car trajectory: the single-rigid-body dynamics (dynamics.py) vs
      gym's 5-body Box2D Car — correlation + error envelopes;
  (d) road-mask IoU: our render_frame road pixels vs a rasterization of
      the reference's road_poly quads under the reference camera
      (car_racing_bezier.py:722-752).

Envelope bounds are set at ~1.25x the divergence measured when the
fixtures were recorded (run `python tests/test_carracing_box2d_parity.py`
to re-measure; values noted inline).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dcd_isaac_tpu.envs.carracing.bezier import get_bezier_track
from dcd_isaac_tpu.envs.carracing.dynamics import (
    car_step, init_car, wheel_positions,
)
from dcd_isaac_tpu.envs.carracing.env import _visit_tiles
from dcd_isaac_tpu.envs.carracing.track import (
    SCALE, STATE_H, STATE_W, TRACK_WIDTH, WINDOW_H, WINDOW_W, ZOOM,
    build_track, on_road, render_frame,
)

FIX = os.path.join(os.path.dirname(__file__), 'fixtures',
                   'carracing_box2d_traces.npz')
DRIVES = ['bez7_ctrl', 'bez11_ctrl', 'bez7_open', 'bez11_open']
CTRL = ['bez7_ctrl', 'bez11_ctrl']


@pytest.fixture(scope='module')
def data():
    return np.load(FIX)


@jax.jit
def _track_and_curve(cps):
    curve = get_bezier_track(cps, rad=0.2, edgy=0.2, numpoints=40)
    return build_track(curve), curve


def our_track(cps):
    track, curve = _track_and_curve(jnp.asarray(cps, jnp.float32))
    return track, np.asarray(curve)


def replay(track, actions):
    """Inner-frame replay mirroring env.step's physics/reward core
    (no shaping/render), including reset's zero-action frame."""
    pos, ang, vel, angvel, step_r, counts = _replay(
        track, jnp.asarray(actions, jnp.float32))
    hull = np.concatenate([
        np.asarray(pos), np.asarray(ang)[:, None], np.asarray(vel),
        np.asarray(angvel)[:, None]], axis=1)          # (T, 6)
    return hull, np.asarray(step_r), np.asarray(counts)


@jax.jit
def _replay(track, actions):
    def frame(carry, act):
        car, visited, reward_total, prev = carry
        wp_road = on_road(track, wheel_positions(car))[0]
        car2 = car_step(car, -act[0], act[1], act[2], wp_road)
        visited2, n_new, _, _ = _visit_tiles(track, visited, car2)
        n_track = jnp.maximum(track.n_points, 1).astype(jnp.float32)
        rt2 = reward_total - 0.1 + 1000.0 / n_track * n_new
        step_r = rt2 - prev
        out = (car2.pos, car2.angle, car2.vel, car2.angvel,
               step_r, visited2.sum())
        return (car2, visited2, rt2, rt2), out

    beta0 = track.beta[0]
    p0 = track.points[0]
    car = init_car(beta0, p0[0], p0[1])
    visited = jnp.zeros((track.capacity,), bool)
    # reference reset() ends with step(None): physics advance + tile
    # contacts (reward credited, prev_reward untouched) but no -0.1
    wp_road = on_road(track, wheel_positions(car))[0]
    car = car_step(car, 0.0, 0.0, 0.0, wp_road)
    visited, n_new, _, _ = _visit_tiles(track, visited, car)
    r0 = 1000.0 / jnp.maximum(track.n_points, 1) * n_new

    _, outs = jax.lax.scan(frame, (car, visited, r0, jnp.float32(0.0)),
                           actions)
    return outs


def measure(data, name):
    cps = data[f'{name}/control_points']
    track, _ = our_track(cps)
    actions = data[f'{name}/actions']
    hull, step_r, counts = replay(track, actions)
    ref = data[f'{name}/hull']       # x y angle vx vy omega
    T = len(ref)
    ours = hull[:T]

    def err_at(k, col):
        k = min(k, T)
        return np.abs(ours[:k, col] - ref[:k, col]).max()

    pos_err = {k: max(err_at(k, 0), err_at(k, 1)) for k in (10, 50, 150)}
    # trajectory correlation over the full episode
    cx = np.corrcoef(ours[:, 0], ref[:, 0])[0, 1]
    cy = np.corrcoef(ours[:, 1], ref[:, 1])[0, 1]
    ref_r = data[f'{name}/rewards']
    ref_counts = data[f'{name}/tile_count']
    cum_ref = np.cumsum(ref_r)
    cum_our = np.cumsum(step_r[:T])
    reward_gap = np.abs(cum_our - cum_ref).max()
    count_gap = abs(int(counts[T - 1]) - int(ref_counts[-1]))
    return dict(pos_err=pos_err, corr=(cx, cy), reward_gap=reward_gap,
                final_tiles=(int(counts[T - 1]), int(ref_counts[-1])),
                count_gap=count_gap, T=T)


def _controller(car, pts, steer_sign=-1.0, lookahead=8, v_target=22.0):
    """The recorder's ground-truth P-controller (record_carracing_traces
    ._controller) applied to OUR car state."""
    import math
    x, y = float(car.pos[0]), float(car.pos[1])
    vx, vy = float(car.vel[0]), float(car.vel[1])
    speed = math.hypot(vx, vy)
    i = int(np.argmin(((pts - [x, y]) ** 2).sum(1)))
    tgt = pts[(i + lookahead) % len(pts)]
    desired = math.atan2(tgt[1] - y, tgt[0] - x)
    heading = float(car.angle) + math.pi / 2
    err = (desired - heading + math.pi) % (2 * math.pi) - math.pi
    return np.array([np.clip(steer_sign * 2.0 * err, -1, 1),
                     np.clip(0.08 + 0.4 * (v_target - speed) / v_target,
                             0, 1),
                     0.8 if speed > v_target * 1.3 else 0.0], np.float32)


def drive_closed_loop(track, T):
    """Drive OUR dynamics with the same controller law the reference trace
    was driven with, returning (tiles_visited, total_reward)."""
    @jax.jit
    def frame(car, visited, reward, act):
        wp_road = on_road(track, wheel_positions(car))[0]
        car2 = car_step(car, -act[0], act[1], act[2], wp_road)
        visited2, n_new, _, _ = _visit_tiles(track, visited, car2)
        n = jnp.maximum(track.n_points, 1).astype(jnp.float32)
        return car2, visited2, reward - 0.1 + 1000.0 / n * n_new

    pts = np.asarray(track.points)[np.asarray(track.valid)]
    car = init_car(track.beta[0], track.points[0, 0], track.points[0, 1])
    visited = jnp.zeros((track.capacity,), bool)
    reward = jnp.float32(0.0)
    car, visited, reward = frame(car, visited, reward, jnp.zeros(3))
    for _ in range(T):
        a = _controller(car, pts)
        car, visited, reward = frame(car, visited, reward, jnp.asarray(a))
    return int(visited.sum()), float(reward)


class TestTrackGeometry:
    @pytest.mark.parametrize('name', CTRL)
    def test_points_betas_offsets_match(self, data, name):
        """(a) identical geometry from identical control points."""
        ref_track = data[f'{name}/track']          # (N, 4) alpha beta x y
        track, curve = our_track(data[f'{name}/control_points'])
        valid = np.asarray(track.valid)
        assert int(valid.sum()) == len(ref_track)
        pts = curve[valid]
        err = np.abs(pts - ref_track[:, 2:4]).max()
        assert err < 0.02, err                     # f32 bezier, coords ±333
        beta = np.asarray(track.beta)[valid]
        dbeta = np.abs(np.angle(np.exp(1j * (beta - ref_track[:, 1]))))
        assert dbeta.max() < 5e-3, dbeta.max()
        off = np.asarray(track.offset)
        assert np.abs(off - data[f'{name}/offsets']).max() < 0.02

    @pytest.mark.parametrize('name', CTRL)
    def test_road_membership_matches_tile_quads(self, data, name):
        """Our nearest-centerline road test vs the reference's Box2D tile
        quads over the playfield (sensor-fixture geometry)."""
        track, _ = our_track(data[f'{name}/control_points'])
        quads = data[f'{name}/road_poly']          # (N, 4, 2) centred
        lo = quads.reshape(-1, 2).min(0) - 5
        hi = quads.reshape(-1, 2).max(0) + 5
        g = 220
        xs = np.linspace(lo[0], hi[0], g)
        ys = np.linspace(lo[1], hi[1], g)
        q = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
        ref_mask = _points_in_quads(q, quads)
        our_mask = np.asarray(
            on_road(track, jnp.asarray(q, jnp.float32))[0])
        inter = (ref_mask & our_mask).sum()
        union = (ref_mask | our_mask).sum()
        iou = inter / max(union, 1)
        assert iou > 0.93, iou                     # measured ~0.97


def _points_in_quads(q, quads):
    """Vectorized point-in-convex-quad over all quads (any hit)."""
    hit = np.zeros(len(q), bool)
    # process in chunks to bound memory: (B, N, 4) cross products
    B = 20000
    a = quads                                       # (N, 4, 2)
    b = np.roll(quads, -1, axis=1)                  # next vertex
    e = b - a                                       # (N, 4, 2)
    for s in range(0, len(q), B):
        p = q[s:s + B][:, None, None, :]            # (B, 1, 1, 2)
        r = p - a[None]                             # (B, N, 4, 2)
        cr = e[None, ..., 0] * r[..., 1] - e[None, ..., 1] * r[..., 0]
        inside = (cr >= 0).all(-1) | (cr <= 0).all(-1)   # (B, N)
        hit[s:s + B] = inside.any(-1)
    return hit


class TestF1Geometry:
    @pytest.mark.parametrize('name', ['f1_Germany', 'f1_Italy'])
    def test_f1_points_subset_of_reference(self, data, name):
        """Our downsampled F1 centerline lies on the reference's track."""
        from dcd_isaac_tpu.envs.carracing.f1 import (
            F1_DOWNSAMPLE, load_f1_tracks,
        )
        ref_track = data[f'{name}/track']
        tname = name[len('f1_'):]
        xy = load_f1_tracks()[tname]['xy']
        track = build_track(jnp.asarray(xy))
        pts = np.asarray(track.points)[np.asarray(track.valid)]
        pts = pts + np.asarray(track.offset)       # back to world coords
        ref_pts = ref_track[:, 2:4]
        # every our-point must be a reference track point (downsampling
        # keeps exact points; offsets differ because the bbox uses the
        # downsampled extremes — compare in world coordinates)
        d = np.abs(pts[:, None, :] - ref_pts[None]).sum(-1).min(1)
        assert d.max() < 1e-3, d.max()
        assert len(pts) * F1_DOWNSAMPLE >= len(ref_pts) - F1_DOWNSAMPLE


class TestTileRewards:
    @pytest.mark.parametrize('name', ['bez7_open', 'bez11_open'])
    def test_open_loop_reward_sequence(self, data, name):
        """(b) open-loop scripts: cumulative reward curve and final tile
        count track Box2D's closely (measured gap <=4.3 reward units —
        a 2-tile transient — and <=1 tile at the horizon, over 300
        frames)."""
        m = measure(data, name)
        assert m['reward_gap'] < 5.5, m
        assert m['count_gap'] <= 2, m

    @pytest.mark.parametrize('name', CTRL)
    def test_closed_loop_driving_parity(self, data, name):
        """(b/c) the same controller achieves the same track progress:
        recorded closed-loop actions diverge once trajectories drift, so
        the fair long-horizon test drives OUR dynamics with the SAME
        controller law and compares tiles/reward (measured: 94 vs 95 and
        110 vs 112 tiles; rewards within 2.5%)."""
        track, _ = our_track(data[f'{name}/control_points'])
        T = len(data[f'{name}/actions'])
        tiles, reward = drive_closed_loop(track, T)
        ref_tiles = int(data[f'{name}/tile_count'][-1])
        ref_reward = float(data[f'{name}/rewards'].sum())
        assert abs(tiles - ref_tiles) <= max(0.08 * ref_tiles, 3), (
            tiles, ref_tiles)
        assert abs(reward - ref_reward) <= max(0.08 * abs(ref_reward), 5), (
            reward, ref_reward)


class TestTrajectory:
    @pytest.mark.parametrize('name', DRIVES)
    def test_hull_position_envelope(self, data, name):
        """(c) single-body dynamics vs Box2D 5-body car under identical
        actions (measured: <=0.06 @10 frames, <=0.98 @50)."""
        m = measure(data, name)
        assert m['pos_err'][10] < 0.08, m
        assert m['pos_err'][50] < 1.25, m

    @pytest.mark.parametrize('name', DRIVES)
    def test_trajectory_correlation(self, data, name):
        """Measured: >=0.943 closed-loop replays, >=0.987 open-loop."""
        m = measure(data, name)
        bound = 0.92 if name in CTRL else 0.97
        assert min(m['corr']) > bound, m


class TestRenderRoadMask:
    @pytest.mark.parametrize('name', ['bez7_ctrl'])
    def test_road_mask_iou_vs_reference_polys(self, data, name):
        """(d) render_frame's road pixels vs the reference's road_poly
        rasterized under the reference camera (render(), :722-752)."""
        track, _ = our_track(data[f'{name}/control_points'])
        quads = data[f'{name}/road_poly']
        hull = data[f'{name}/hull']
        for t_step in (30, 200):
            if t_step >= len(hull):
                continue
            pos = hull[t_step, 0:2]
            angle = hull[t_step, 2]
            t_sim = (t_step + 2) / 50.0
            img = np.asarray(render_frame(
                track, jnp.asarray(pos, jnp.float32), jnp.float32(angle),
                jnp.zeros(2), jnp.float32(0), jnp.zeros(4),
                jnp.float32(0), jnp.float32(t_sim)))
            # road pixels: gray 0.4..0.43 on all channels
            ours = ((np.abs(img[..., 0].astype(int) - 105) < 8)
                    & (img[..., 1] == img[..., 0])
                    & (img[..., 2] == img[..., 0]))
            ref = _rasterize_quads_reference_camera(
                quads, pos, angle, t_sim)
            # exclude the car sprite + indicator bar rows from both
            mask = np.ones((STATE_H, STATE_W), bool)
            mask[-12:] = False
            cx, cy = STATE_W // 2, int(STATE_H * 3 / 4)
            mask[cy - 12:cy + 12, cx - 6:cx + 6] = False
            inter = (ours & ref & mask).sum()
            union = ((ours | ref) & mask).sum()
            iou = inter / max(union, 1)
            assert iou > 0.90, (t_step, iou)       # measured ~0.95


def _rasterize_quads_reference_camera(quads, pos, angle, t_sim):
    """Reference state_pixels camera: zoom ramp, car at (W/2, H/4),
    rotation -hull.angle, viewport scale (96/1000, 96/800)."""
    zoom = 0.1 * SCALE * max(1 - t_sim, 0) + ZOOM * SCALE * min(t_sim, 1)
    sx = zoom * STATE_W / WINDOW_W
    sy = zoom * STATE_H / WINDOW_H
    i = np.arange(STATE_W, dtype=np.float64)
    j = np.arange(STATE_H, dtype=np.float64)
    px, py = np.meshgrid(i, j, indexing='xy')
    ex = (px - STATE_W / 2) / sx
    ey = ((STATE_H - 1 - py) - STATE_H / 4) / sy
    ca, sa = np.cos(angle), np.sin(angle)
    wx = pos[0] + ex * ca - ey * sa
    wy = pos[1] + ex * sa + ey * ca
    q = np.stack([wx, wy], -1).reshape(-1, 2)
    return _points_in_quads(q, quads).reshape(STATE_H, STATE_W)


if __name__ == '__main__':
    # measurement mode: print actual divergences for envelope calibration
    d = np.load(FIX)
    for n in DRIVES:
        print(n, measure(d, n))
