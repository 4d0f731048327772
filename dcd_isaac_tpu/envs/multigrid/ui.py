"""Interactive MultiGrid viewer + keyboard driver.

Accelerator-native stand-in for the reference UI tools
(envs/multigrid/window.py: matplotlib Window;
envs/multigrid/manual_control.py: keyboard driver): a `Window` that renders
the JAX env state as an image, and `manual_control()` that binds keys to
actions and steps the env interactively.  Host-side only — for inspecting
levels and playing episodes by hand; never part of the training path.

    python -m dcd_isaac_tpu.envs.multigrid.ui --env_name MultiGrid-Adversarial-v0
"""

from __future__ import annotations

import numpy as np

from ...utils.screenshots import render_multigrid_level

KEY_TO_ACTION = {
    'left': 0,       # rotate left
    'right': 1,      # rotate right
    'up': 2,         # forward
    ' ': 5,          # toggle
    'pageup': 3,     # pickup
    'pagedown': 4,   # drop
    'enter': 6,      # done (no-op)
}


def render_state(state, tile: int = 24) -> np.ndarray:
    """MultiGridState → RGB image with the agent triangle direction."""
    from .core import encode_grid
    enc = np.asarray(encode_grid(state))
    img = render_multigrid_level(enc, tile=tile)
    # mark the agent heading with a bright wedge
    pos = np.asarray(state.agent_pos)
    if pos[0] >= 0:
        d = int(np.asarray(state.agent_dir))
        cx, cy = pos[0] * tile + tile // 2, pos[1] * tile + tile // 2
        dx, dy = [(1, 0), (0, 1), (-1, 0), (0, -1)][d]
        for r in range(tile // 2):
            x, y = cx + dx * r, cy + dy * r
            img[max(y, 0):y + 2, max(x, 0):x + 2] = (255, 255, 0)
    return img


class Window:
    """Matplotlib image window (reference envs/multigrid/window.py)."""

    def __init__(self, title: str):
        import matplotlib.pyplot as plt
        self.plt = plt
        self.fig, self.ax = plt.subplots()
        self.fig.canvas.manager.set_window_title(title)
        self.ax.set_axis_off()
        self.imshow_obj = None
        self.closed = False
        self.fig.canvas.mpl_connect(
            'close_event', lambda evt: setattr(self, 'closed', True))

    def show_img(self, img: np.ndarray):
        if self.imshow_obj is None:
            self.imshow_obj = self.ax.imshow(img, interpolation='bilinear')
        else:
            self.imshow_obj.set_data(img)
        self.fig.canvas.draw_idle()
        self.plt.pause(0.001)

    def set_caption(self, text: str):
        self.ax.set_title(text, fontsize=9)

    def reg_key_handler(self, handler):
        self.fig.canvas.mpl_connect('key_press_event', handler)

    def show(self, block: bool = True):
        self.plt.show(block=block)

    def close(self):
        self.plt.close(self.fig)


def manual_control(env_name: str = 'MultiGrid-Adversarial-v0', seed: int = 0,
                   agent_view: bool = False):
    """Play an env with the keyboard (reference manual_control.py).

    arrows = turn/forward, space = toggle, pgup/pgdn = pickup/drop,
    backspace = reset, escape = quit.
    """
    import jax
    import jax.numpy as jnp

    from ..registry import make_env
    from .core import gen_obs

    env = make_env(env_name)
    rng = jax.random.PRNGKey(seed)
    window = Window(f'dcd_isaac_tpu — {env_name}')

    box = {'state': None, 'rng': rng, 'ret': 0.0, 'steps': 0}

    def redraw():
        state = box['state']
        if agent_view:
            obs = gen_obs(state, env.params)
            img = render_multigrid_level(np.asarray(obs['image']), tile=48)
        else:
            img = render_state(state)
        window.set_caption(
            f"steps={box['steps']} return={box['ret']:.3f}")
        window.show_img(img)

    def reset():
        box['rng'], r = jax.random.split(box['rng'])
        state, _ = env.reset_random(r)
        state, _ = env.reset_agent(state)
        box.update(state=state, ret=0.0, steps=0)
        redraw()

    def key_handler(event):
        if event.key == 'escape':
            window.close()
            return
        if event.key == 'backspace':
            reset()
            return
        action = KEY_TO_ACTION.get(event.key)
        if action is None:
            return
        state, obs, reward, done, _ = env.step(
            box['state'], jnp.int32(action))
        box['state'] = state
        box['ret'] += float(reward)
        box['steps'] += 1
        if bool(done):
            print(f"done! return={box['ret']:.3f} steps={box['steps']}")
            reset()
        else:
            redraw()

    window.reg_key_handler(key_handler)
    reset()
    window.show(block=True)


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument('--env_name', default='MultiGrid-Adversarial-v0')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--agent_view', action='store_true')
    cli = ap.parse_args()
    manual_control(cli.env_name, cli.seed, cli.agent_view)
