#!/usr/bin/env python3
"""Smoke run of the DCD training cycle on the GPU.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --multichip   # four GPUs: the dp:4 mesh check only
    python chip_smoke.py --rehearse    # any platform, tiny sizes, no result

Each phase runs as a child process through an entry point a user calls,
with its own time limit. This process never imports JAX, so exactly one
process holds the card at a time. Any failed phase ends the script with a
non-zero exit code and without the result line.

One-GPU phases, in order:
  device    the card's name and power limit (nvidia-smi); JAX must report
            platform 'gpu' — nothing falls back to the CPU
  train     mg_25b_paired.json at full width (N=32, T=256, LSTM-256
            students, recurrent conv-128 teacher): 2 updates at K=1 with
            the in-training evaluator, then a restart that resumes from the
            checkpoint and runs 8 more updates as two K=4 dispatches
  eval      ``python -m dcd_isaac_tpu.eval --benchmark maze`` on that run
  bench     ``python bench.py`` at its default size (N=8192, T=256)
  families  bipedal_accel.json (N=16, T=2048) and cr_robust_plr.json
            (N=16, T=125) at K=2: four cycles each. The PLR buffer is cut to
            one cycle's levels (N), so that from cycle 2 on the buffer is
            full and cycles replay (walker: and edit) as they do for most
            of a real run; at least one replay must run. The rollout scan
            is not unrolled (--rollout_unroll 1, numerically the same): at
            the default 4 these two programs alone take ~9 min to compile
  numerics  ``JAX_PLATFORMS=cuda python -m pytest -m chip tests/``

``--multichip`` trains mg_25b_repaired.json (PAIRED+PLR, replay off so
every cycle runs the one generate program) at N=8192 for 3 cycles with
``--mesh_shape dp:4`` and on one card from the same seed, in f32 at the
highest matmul precision, and compares their per-cycle stats and
parameters.

The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import ast
import csv
import json
import math
import os
import pickle
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, '.smoke_runs')      # listed in .gitignore
CONFIGS = os.path.join(ROOT, 'train_scripts', 'grid_configs')
BUDGET_S = 1150          # the whole script, compilation included


class PhaseFailed(Exception):
    pass


class Smoke:
    def __init__(self, rehearse: bool):
        self.rehearse = rehearse
        self.t_start = time.monotonic()

    # --- child processes ---------------------------------------------------
    def run(self, tag: str, cmd: list, limit_s: float, env=None) -> str:
        """Run one child with a time limit; return its stdout. The child's
        output goes to .smoke_runs/<tag>.log; on failure its tail is shown."""
        left = BUDGET_S - (time.monotonic() - self.t_start)
        limit_s = min(limit_s, left)
        if limit_s <= 0:
            raise PhaseFailed(f'{tag}: no time left in the {BUDGET_S} s budget')
        log = os.path.join(WORK, f'{tag}.log')
        print(f'[{tag}] {" ".join(cmd)}', flush=True)
        t0 = time.monotonic()
        proc = subprocess.Popen(
            cmd, cwd=ROOT, env={**os.environ, **(env or {})},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=limit_s)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
            self._dump(log, out)
            raise PhaseFailed(f'{tag}: no result within {limit_s:.0f} s')
        self._dump(log, out)
        print(f'[{tag}] exit {proc.returncode} after '
              f'{time.monotonic() - t0:.1f} s', flush=True)
        if proc.returncode != 0:
            raise PhaseFailed(f'{tag}: exit code {proc.returncode}')
        return out

    @staticmethod
    def _dump(log: str, out: str):
        with open(log, 'w') as f:
            f.write(out or '')
        tail = (out or '').splitlines()[-25:]
        if tail:
            print('\n'.join(f'    | {line}' for line in tail), flush=True)

    def train(self, tag: str, config: str, overrides: dict, limit_s: float,
              env=None) -> str:
        argv = config_argv(config, {'log_dir': WORK, 'xpid': tag,
                                    **overrides})
        return self.run(tag, [sys.executable, '-m', 'dcd_isaac_tpu.train',
                              *argv], limit_s, env)

    # --- phases --------------------------------------------------------------
    def device(self, want_count: int) -> dict:
        try:
            smi = subprocess.run(
                ['nvidia-smi', '--query-gpu=name,power.limit',
                 '--format=csv,noheader'], capture_output=True, text=True,
                timeout=60)
            gpus = smi.stdout.strip()
            ok = smi.returncode == 0 and bool(gpus)
        except (OSError, subprocess.TimeoutExpired) as e:
            gpus, ok = f'unavailable ({e})', False
        if not ok and not self.rehearse:
            raise PhaseFailed(f'device: no GPU (nvidia-smi: {gpus})')
        print(f'[device] nvidia-smi name, power.limit: {gpus}', flush=True)
        out = self.run('device', [sys.executable, '-m',
                                  'dcd_isaac_tpu.utils.device'], 120)
        dev = json.loads(out.strip().splitlines()[-1])
        print(f'[device] jax: {dev}', flush=True)
        if dev['platform'] != 'gpu' and not self.rehearse:
            raise PhaseFailed(
                f"device: JAX found platform {dev['platform']!r}, not a GPU")
        if dev['count'] < want_count and not self.rehearse:
            raise PhaseFailed(
                f"device: {want_count} GPUs needed, JAX found {dev['count']}")
        return dev

    def phase_train(self):
        cfg = 'minigrid/25_blocks/mg_25b_paired.json'
        N, T = (4, 8) if self.rehearse else (32, 256)
        base = {'num_processes': N, 'num_steps': T, 'log_interval': 1,
                'checkpoint': True, 'screenshot_interval': 0}
        out_a = self.train('mg_paired', cfg, {
            **base, 'num_env_steps': 2 * N * T, 'cycles_per_dispatch': 1,
            'test_interval': 100}, 900)
        rows_a = read_logs('mg_paired')
        expect(len(rows_a) == 2, f'train: 2 rows at K=1, got {len(rows_a)}')
        expect(any(k.startswith('solved_rate:') for k in rows_a[0]),
               'train: the in-training evaluator did not run')
        # restart: resumes from the saved update, two K=4 dispatches
        out_b = self.train('mg_paired_resume', cfg, {
            **base, 'num_env_steps': 10 * N * T, 'cycles_per_dispatch': 4,
            'test_interval': 0, 'xpid': 'mg_paired'}, 900)
        expect('Resumed from update 2' in out_b,
               'train: the restart did not resume from update 2')
        rows = read_logs('mg_paired')
        expect(len(rows) == 10, f'train: 10 rows after resume, got {len(rows)}')
        check_finite('train', rows, ('mean_agent_return', 'agent_value_loss',
                                     'agent_pg_loss', 'adversary_value_loss',
                                     'adversary_env_value_loss'))
        ckpt = os.path.join(WORK, 'mg_paired', 'model.tar')
        expect(os.path.isfile(ckpt), f'train: no checkpoint at {ckpt}')
        t = [float(r['cycle_time_s']) for r in rows]
        print(f'[train] K=1: first cycle {t[0]:.3f} s (incl. compile), '
              f'steady {t[1]:.3f} s/cycle; K=4: first dispatch '
              f'{4 * t[2]:.3f} s (incl. compile), steady {t[-1]:.3f} s/cycle; '
              f'{peak(out_a)} (K=1 run), {peak(out_b)} (K=4 run)', flush=True)

    def phase_eval(self):
        out = self.run('eval', [
            sys.executable, '-m', 'dcd_isaac_tpu.eval', '--base_path', WORK,
            '--prefix', 'mg_paired', '--benchmark', 'maze',
            '--num_episodes', '10',
            '--result_path', os.path.join(WORK, 'eval')], 600)
        path = re.search(r'Wrote (\S+)', out).group(1)
        with open(path) as f:
            rows = list(csv.reader(f))[1:]
        rates = {r[0]: float(r[1]) for r in rows if r[0].startswith(
            'solved_rate:')}
        expect(rates and all(math.isfinite(v) for v in rates.values()),
               f'eval: solved rates not finite: {rates}')
        print(f'[eval] {len(rates)} maze envs, mean solved rate '
              f'{sum(rates.values()) / len(rates):.3f}; {peak(out)}',
              flush=True)

    def phase_bench(self):
        cmd = [sys.executable, 'bench.py'] + (['--quick'] if self.rehearse
                                              else [])
        out = self.run('bench', cmd, 900)
        line = [ln for ln in out.splitlines() if ln.startswith('{')][-1]
        res = json.loads(line)
        expect(math.isfinite(res['value']) and res['value'] > 0,
               f'bench: bad value {res}')
        print(f'[bench] {line}', flush=True)
        print(f"[bench] peak_bytes_in_use={res['peak_bytes_in_use']}, "
              f"compile+2 warm-up cycles {res['compile_s']} s", flush=True)

    def phase_families(self):
        for tag, cfg, (N, T) in (
                ('walker_accel', 'bipedal/bipedal_accel.json', (16, 2048)),
                ('cr_robust_plr', 'car_racing/cr_robust_plr.json', (16, 125))):
            if self.rehearse:
                N = 4       # T stays: a buffer fills only with ended episodes
            out = self.train(tag, cfg, {
                'num_processes': N, 'num_steps': T, 'num_env_steps': 4 * N * T,
                'cycles_per_dispatch': 2, 'level_replay_seed_buffer_size': N,
                'rollout_unroll': 1, 'log_interval': 1, 'test_interval': 0,
                'checkpoint': False, 'screenshot_interval': 0}, 600)
            rows = read_logs(tag)
            expect(len(rows) == 4, f'{tag}: 4 rows, got {len(rows)}')
            check_finite(tag, rows, ('mean_agent_return', 'agent_value_loss',
                                     'agent_pg_loss'))
            replays = sum(int(r['level_replay']) for r in rows)
            edits = int(rows[-1]['total_num_edits'])
            grads = int(rows[-1]['total_student_grad_updates'])
            expect(replays > 0, f'{tag}: no replay cycle ran')
            expect(edits > 0 or tag != 'walker_accel',
                   f'{tag}: no ACCEL edit ran')
            t = [float(r['cycle_time_s']) for r in rows]
            print(f"[{tag}] N={N} T={T} K=2: first dispatch {2 * t[0]:.3f} s "
                  f"(incl. compile), steady {t[-1]:.3f} s/cycle; "
                  f"{replays} replay cycles, {edits} edits, {grads} student "
                  f"updates in 4 cycles; {peak(out)}", flush=True)

    def phase_numerics(self):
        out = self.run('numerics', [
            sys.executable, '-m', 'pytest', '-m', 'chip', 'tests/', '-q',
            '-rs', '--durations=8', '-p', 'no:cacheprovider'], 900,
            env=None if self.rehearse else {'JAX_PLATFORMS': 'cuda'})
        print(f'[numerics] {out.strip().splitlines()[-1]}', flush=True)
        if not self.rehearse:
            problem = numerics_problem(out)
            expect(problem is None, f'numerics: {problem}')

    def multichip(self):
        cfg = 'minigrid/25_blocks/mg_25b_repaired.json'
        N, T = (16, 8) if self.rehearse else (8192, 256)
        # f32 with f32 matmuls (no bf16, no TF32): the two runs then differ
        # only in reduction order, so the tolerances below can be tight
        base = {'num_processes': N, 'num_steps': T, 'log_interval': 1,
                'checkpoint': True, 'test_interval': 0, 'seed': 1,
                'screenshot_interval': 0, 'level_replay_prob': 0.0,
                'bf16': False}
        f32 = {'JAX_DEFAULT_MATMUL_PRECISION': 'highest'}
        one = {**f32, **({} if self.rehearse else {'CUDA_VISIBLE_DEVICES': '0'})}
        # initial params depend on the seed only, not on N: take them from a
        # small CPU run, which holds no card and runs beside the dp:4 run
        init_failed = []

        def init_run():
            try:
                self.train('mc_init', cfg, {**base, 'num_env_steps': 0,
                                            'num_processes': 8}, 300,
                           {'JAX_PLATFORMS': 'cpu'})
            except PhaseFailed as e:
                init_failed.append(e)
        init = threading.Thread(target=init_run)
        init.start()
        out4 = self.train('mc_dp4', cfg, {**base, 'num_env_steps': 3 * N * T,
                                          'mesh_shape': 'dp:4'}, 900, f32)
        init.join()
        if init_failed:
            raise init_failed[0]
        out1 = self.train('mc_one', cfg, {**base, 'num_env_steps': 3 * N * T},
                          900, one)
        m = re.search(r'mesh placement (\{.*\})', out4)
        placement = ast.literal_eval(m.group(1)) if m else {}
        print(f'[multichip] dp:4 leaves by devices spanned: {placement}',
              flush=True)
        expect(set(placement) == {4},
               f'multichip: a leaf is not spread over all 4 devices '
               f'({placement})')
        rows4, rows1 = read_logs('mc_dp4'), read_logs('mc_one')
        expect(len(rows4) == len(rows1) == 3, 'multichip: 3 cycles each')
        # Per-cycle stats: rel 2e-3 + abs 2e-4. The gradient psum over 4
        # shards and the GEMMs over 2048-row shards sum in another order
        # than one 8192-row batch (f32 rounding, ~1e-7 relative). A logit
        # that rounding moves across a sampling boundary changes one env's
        # trajectory, which moves a mean over 8192 envs by ~1e-4; the
        # absolute floor covers stats that sit near zero.
        keys = ('mean_agent_return', 'mean_adversary_agent_return',
                'mean_env_return', 'agent_value_loss',
                'adversary_value_loss', 'adversary_env_value_loss',
                'agent_dist_entropy', 'adversary_env_dist_entropy',
                'level_replay')
        worst = 0.0
        for i, (a, b) in enumerate(zip(rows4, rows1)):
            for k in keys:
                if k not in a or a[k] == '':
                    continue
                x, y = float(a[k]), float(b[k])
                err = abs(x - y) / (2e-3 * max(abs(x), abs(y)) + 2e-4)
                worst = max(worst, err)
                print(f'[multichip] cycle {i} {k}: dp4 {x:.6g} one {y:.6g}',
                      flush=True)
        # Params: the dp:4 run's change from the shared initial params must
        # match the one-card change to 1% in L2 norm (the same rounding,
        # carried through 3 cycles x 5 epochs of Adam).
        init = load_state('mc_init')
        s4, s1 = load_state('mc_dp4'), load_state('mc_one')
        param_err = {}
        for role in ('agent', 'adversary_agent', 'adversary_env'):
            pre = f'.{role}.params'
            d4 = d1 = dd = 0.0
            for k, v in init.items():
                if k.startswith(pre):
                    a = s4[k].astype('float64') - v
                    b = s1[k].astype('float64') - v
                    d1 += float((b ** 2).sum())
                    dd += float(((a - b) ** 2).sum())
            param_err[role] = math.sqrt(dd) / max(math.sqrt(d1), 1e-30)
        print(f'[multichip] params |d_dp4 - d_one| / |d_one|: {param_err}',
              flush=True)
        t4 = [float(r['cycle_time_s']) for r in rows4]
        t1 = [float(r['cycle_time_s']) for r in rows1]
        print(f'[multichip] cycle times s: dp4 {t4}, one card {t1}; steady '
              f'speed-up {t1[-1] / t4[-1]:.3f}x on 4 cards; {peak(out4)} '
              f'(dp4), {peak(out1)} (one)', flush=True)
        expect(worst <= 1.0, f'multichip: stats differ beyond tolerance '
                             f'({worst:.3f} x tolerance)')
        expect(all(e <= 0.01 for e in param_err.values()),
               f'multichip: params differ beyond 1%: {param_err}')


# --- helpers ---------------------------------------------------------------
def expect(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def numerics_problem(out: str):
    """What is wrong with a ``pytest -m chip -rs`` run, or None. A module
    skipped for a missing optional package is no chip test; a chip test
    that skipped (its fixture found no GPU) or failed is a problem."""
    summary = out.strip().splitlines()[-1]
    passed = re.search(r'(\d+) passed', summary)
    if re.search(r'failed|error', summary):
        return summary
    if not passed or int(passed.group(1)) == 0:
        return f'no chip test passed: {summary}'
    chip_skips = re.findall(r'SKIPPED .*chip test:.*', out)
    if chip_skips:
        return f'{len(chip_skips)} chip test lines skipped: {chip_skips[0]}'
    return None


def config_argv(config: str, overrides: dict) -> list:
    """First value of each key of a reference grid config, as CLI flags."""
    with open(os.path.join(CONFIGS, config)) as f:
        grid = json.load(f)['grid']
    params = {k: v[0] for k, v in grid.items()}
    params.update(overrides)
    argv = []
    for k, v in params.items():
        if isinstance(v, bool):
            v = 'true' if v else 'false'
        argv += [f'--{k}', str(v)]
    return argv


def read_logs(xpid: str) -> list:
    with open(os.path.join(WORK, xpid, 'logs.csv')) as f:
        return list(csv.DictReader(f))


def check_finite(tag: str, rows: list, keys):
    for k in keys:
        vals = [float(r[k]) for r in rows if r.get(k, '') != '']
        expect(vals, f'{tag}: no {k} in logs.csv')
        expect(all(math.isfinite(v) for v in vals), f'{tag}: {k} = {vals}')


def peak(out: str) -> str:
    m = re.search(r'peak_bytes_in_use=(\S+)', out)
    return f'peak_bytes_in_use={m.group(1) if m else "not reported"}'


def load_state(xpid: str) -> dict:
    with open(os.path.join(WORK, xpid, 'model.tar'), 'rb') as f:
        return pickle.load(f)['state']


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--multichip', action='store_true',
                      help='four GPUs: the dp:4 mesh against one card')
    ap.add_argument('--rehearse', action='store_true',
                    help='any platform, tiny sizes; never prints a result')
    cli = ap.parse_args()

    if not os.path.isdir(os.path.join(ROOT, 'dcd_isaac_tpu')):
        print('chip_smoke.py: the dcd_isaac_tpu package is not beside this '
              'script', file=sys.stderr)
        return 1
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    smoke = Smoke(cli.rehearse)
    try:
        dev = smoke.device(4 if cli.multichip else 1)
        if cli.multichip:
            smoke.multichip()
        else:
            for phase in (smoke.phase_train, smoke.phase_eval,
                          smoke.phase_bench, smoke.phase_families,
                          smoke.phase_numerics):
                phase()
    except PhaseFailed as e:
        print(f'chip_smoke.py: FAILED: {e}', file=sys.stderr, flush=True)
        return 1
    finally:
        print(f'total {time.monotonic() - smoke.t_start:.1f} s', flush=True)
    if cli.rehearse:
        print('rehearsal finished: every phase ran (no result line)')
        return 0
    print(json.dumps({'ok': True, 'device': dev}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
