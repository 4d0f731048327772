"""CPU probe for the r4 walker device fault (NaN in the cycle program).

Loads the r4 walker ACCEL checkpoint (u200), audits every float leaf of the
runner state for NaN/Inf, then steps sequential cycles on CPU until a NaN
appears anywhere in the state, reporting the first poisoned component.

Usage:  JAX_PLATFORMS=cpu python tools/probe_walker_nan.py [run_dir] [max_cycles]
"""
import argparse
import json
import os
import sys
import time

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
os.environ['DCD_ALLOW_STALE_LEVEL_ENCODING'] = '1'

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dcd_isaac_tpu.arguments import parser  # noqa: E402
from dcd_isaac_tpu.envs.registry import make_env  # noqa: E402
from dcd_isaac_tpu.runner.adversarial_runner import AdversarialRunner  # noqa: E402
from dcd_isaac_tpu.utils.checkpoint import load_checkpoint  # noqa: E402
from dcd_isaac_tpu.utils.make_agent import make_all_models  # noqa: E402


def audit(tag, tree, verbose=False):
    """Print every float leaf containing NaN/Inf; return True if any."""
    bad = False
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in leaves:
        if not hasattr(leaf, 'dtype'):
            continue
        if not jnp.issubdtype(leaf.dtype, jnp.floating):
            continue
        arr = np.asarray(leaf)
        n_nan = int(np.isnan(arr).sum())
        n_inf = int(np.isinf(arr).sum())
        finite = arr[np.isfinite(arr)]
        amax = float(np.abs(finite).max()) if finite.size else 0.0
        if n_nan or n_inf:
            bad = True
            print(f'  [{tag}] {jax.tree_util.keystr(path)}: '
                  f'nan={n_nan} inf={n_inf} shape={arr.shape} '
                  f'finite_absmax={amax:.3e}', flush=True)
        elif verbose and amax > 1e6:
            print(f'  [{tag}] LARGE {jax.tree_util.keystr(path)}: '
                  f'absmax={amax:.3e} shape={arr.shape}', flush=True)
    return bad


def main():
    run_dir = sys.argv[1] if len(sys.argv) > 1 else \
        'results/runs/r4_walker_accel_s1'
    max_cycles = int(sys.argv[2]) if len(sys.argv) > 2 else 80

    meta = json.load(open(os.path.join(run_dir, 'meta.json')))['args']
    args = parser.parse_args([])
    for k, v in meta.items():
        setattr(args, k, v)
    args.cycles_per_dispatch = 1
    args.debug_nans = False
    args.rollout_unroll = 1

    env = make_env(args.env_name, full_obs=False, args=args)
    models = make_all_models(args, env)
    runner = AdversarialRunner(args, env, models, jax.random.PRNGKey(args.seed))
    runner.state, host = load_checkpoint(
        os.path.join(run_dir, 'model.tar'), runner.state)
    runner.load_host_state_dict(host)
    u0 = runner.num_updates
    print(f'Resumed at update {u0}', flush=True)

    print('=== checkpoint audit ===', flush=True)
    ck_bad = audit('ckpt', runner.state, verbose=True)
    print(f'checkpoint poisoned: {ck_bad}', flush=True)

    for i in range(max_cycles):
        t0 = time.perf_counter()
        stats = runner.run()
        dt = time.perf_counter() - t0
        u = runner.num_updates
        bad = audit(f'u{u}', runner.state)
        srt = {}
        for k, v in stats.items():
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue
            if np.isnan(fv) or np.isinf(fv):
                srt[k] = fv
        print(f'u{u} dt={dt:.1f}s ret={stats.get("mean_agent_return", 0):.3f} '
              f'vl={stats.get("value_loss", 0):.4f} '
              f'bad_state={bad} bad_stats={sorted(srt)[:6]}', flush=True)
        if bad:
            print('=== first poisoned state; full audit ===', flush=True)
            audit('final', runner.state, verbose=True)
            break


if __name__ == '__main__':
    main()
