"""Standalone zero-shot evaluation CLI (reference eval.py).

``python -m dcd_isaac_tpu.eval --base_path=~/logs/dcd --prefix=<xpid prefix>
--benchmark=maze`` — loads each matching xpid's meta.json + model.tar,
evaluates the student on the benchmark suite (maze / f1 / bipedal /
poetrose, eval.py:332-368) and writes a result CSV with mean±std rows per
env plus IQR/mean aggregates (eval.py:508-525).
"""

from __future__ import annotations

import argparse
import csv
import fnmatch
import json
import os
from typing import Dict, List

import jax
import numpy as np

from .arguments import parser as train_parser
from .envs.registry import make_env
from .runner.adversarial_runner import AdversarialRunner
from .runner.evaluation import Evaluator, benchmark_env_names
from .utils.checkpoint import load_checkpoint
from .utils.make_agent import make_all_models


def parse_args(argv=None):
    p = argparse.ArgumentParser('dcd_isaac_tpu eval')
    p.add_argument('--base_path', type=str, default='~/logs/dcd')
    p.add_argument('--prefix', type=str, default='latest')
    p.add_argument('--benchmark', type=str, default=None,
                   help='maze | f1 | bipedal | poetrose')
    p.add_argument('--env_names', type=str, default='')
    p.add_argument('--num_episodes', type=int, default=100)
    p.add_argument('--seed', type=int, default=1)
    p.add_argument('--model_tar', type=str, default='model')
    p.add_argument('--deterministic', type=lambda v: v in ('1', 'true'),
                   default=False)
    p.add_argument('--result_path', type=str, default='eval_results/')
    p.add_argument('--accumulator', type=str, default=None,
                   help="e.g. 'mean' to also log the cross-env mean")
    return p.parse_args(argv)


def find_xpids(base_path: str, prefix: str) -> List[str]:
    base_path = os.path.expanduser(base_path)
    if not os.path.isdir(base_path):
        return []
    pattern = prefix if any(c in prefix for c in '*?[') else prefix + '*'
    return sorted(
        d for d in os.listdir(base_path)
        if fnmatch.fnmatch(d, pattern)
        and os.path.isfile(os.path.join(base_path, d, 'meta.json')))


def load_agent(base_path: str, xpid: str, model_tar: str):
    """meta.json args + checkpoint → (train_args, model, params)."""
    xdir = os.path.join(os.path.expanduser(base_path), xpid)
    with open(os.path.join(xdir, 'meta.json')) as f:
        meta = json.load(f)
    argv = []
    defaults = vars(train_parser.parse_args([]))
    for k, v in meta['args'].items():
        if k in defaults and v is not None and v != defaults[k]:
            argv.extend([f'--{k}', str(v)])
    args = train_parser.parse_args(argv)

    env = make_env(args.env_name, args=args)
    models = make_all_models(args, env)
    runner = AdversarialRunner(args, env, models, jax.random.PRNGKey(0))
    ckpt = os.path.join(xdir, f'{model_tar}.tar')
    state, _ = load_checkpoint(ckpt, runner.state)
    return args, models['agent'], state.agent.params


def evaluate_xpid(cli, xpid: str, env_names: List[str]) -> Dict[str, float]:
    args, model, params = load_agent(cli.base_path, xpid, cli.model_tar)
    ev = Evaluator(env_names, num_episodes=cli.num_episodes,
                   deterministic=cli.deterministic)
    return ev.evaluate(model, params, seed=cli.seed)


def main(argv=None):
    cli = parse_args(argv)
    from .utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    if cli.benchmark:
        env_names = benchmark_env_names(cli.benchmark)
    else:
        env_names = [e for e in cli.env_names.split(',') if e]
    assert env_names, 'Provide --benchmark or --env_names'

    xpids = find_xpids(cli.base_path, cli.prefix)
    assert xpids, f'No xpids matching {cli.prefix} under {cli.base_path}'

    rows: Dict[str, Dict[str, float]] = {}
    for xpid in xpids:
        print(f'Evaluating {xpid} on {len(env_names)} envs...', flush=True)
        rows[xpid] = evaluate_xpid(cli, xpid, env_names)

    os.makedirs(os.path.expanduser(cli.result_path), exist_ok=True)
    out = os.path.join(
        os.path.expanduser(cli.result_path),
        f"{cli.benchmark or 'custom'}-{cli.prefix.rstrip('*')}.csv")

    # rows: metric x per-xpid columns + mean/std + IQR aggregate
    # (reference eval.py:508-517: q1--median--q3 over seeds, midpoint interp)
    metrics = sorted({m for r in rows.values() for m in r})
    with open(out, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(['metric'] + list(rows) + ['mean', 'std', 'iq'])
        for m in metrics:
            vals = [rows[x].get(m, float('nan')) for x in rows]
            q1 = np.percentile(vals, 25, method='midpoint')
            q3 = np.percentile(vals, 75, method='midpoint')
            med = np.median(vals)
            w.writerow([m] + [f'{v:.4f}' for v in vals]
                       + [f'{np.nanmean(vals):.4f}',
                          f'{np.nanstd(vals):.4f}',
                          f'{q1:.2f}--{med:.2f}--{q3:.2f}'])
        if cli.accumulator == 'mean':
            for kind in ('solved_rate', 'test_returns'):
                vals = [np.nanmean([v for k, v in rows[x].items()
                                    if k.startswith(kind)]) for x in rows]
                w.writerow([f'{kind}:mean'] + [f'{v:.4f}' for v in vals]
                           + [f'{np.nanmean(vals):.4f}',
                              f'{np.nanstd(vals):.4f}'])
    print(f'Wrote {out}')
    from .utils.device import device_report
    print(device_report(), flush=True)
    return out


if __name__ == '__main__':
    main()
