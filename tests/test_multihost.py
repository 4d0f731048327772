"""Multi-host path: 2 jax.distributed processes over localhost DCN.

VERDICT r2 item 4 — `--multihost` existed but nothing exercised
jax.distributed + DCN semantics. This test spawns two REAL processes
(CPU backend, 4 virtual devices each → one 8-device dp mesh spanning
processes), trains the product path (`train.main` with `--multihost
--mesh_shape dp:8`) with checkpointing, then RESTARTS both processes and
verifies resume from the sharded-checkpoint across the process restart.

The multi-host launch recipe this encodes (README): every host runs the
same command with --multihost --coordinator_address=<host0>:<port>
--num_hosts=N --host_idx=<i>. On GPU hosts the three flags are required
(nothing tells jax.distributed of the cluster); this 2-process CPU test is
the only place the path runs.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update('jax_platforms', 'cpu')
    from dcd_isaac_tpu.train import main

    pid = int(sys.argv[1])
    port = sys.argv[2]
    updates = sys.argv[3]
    logdir = sys.argv[4]

    runner = main([
        '--multihost', 'true',
        '--coordinator_address', f'127.0.0.1:{{port}}',
        '--num_hosts', '2', '--host_idx', str(pid),
        '--mesh_shape', 'dp:8',
        '--env_name', 'MultiGrid-MiniAdversarial-v0',
        '--ued_algo', 'paired',
        '--num_processes', '8', '--num_steps', '16',
        '--num_env_steps', updates,
        '--use_plr', 'true', '--level_replay_prob', '0.5',
        '--level_replay_seed_buffer_size', '16',
        '--test_env_names=', '--screenshot_interval', '0',
        '--log_interval', '1', '--checkpoint', 'true',
        '--checkpoint_interval', '1',
        '--log_dir', logdir, '--xpid', 'mh_test',
    ])
    print(f'WORKER{{pid}} DONE updates={{runner.num_updates}}', flush=True)
""")


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(tmp_path, port, updates):
    script = tmp_path / 'worker.py'
    script.write_text(WORKER.format(repo=REPO))
    env = dict(os.environ)
    env['JAX_PLATFORMS'] = 'cpu'
    env['XLA_FLAGS'] = (
        env.get('XLA_FLAGS', '').replace(
            '--xla_force_host_platform_device_count=8', '')
        + ' --xla_force_host_platform_device_count=4').strip()
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), str(port), str(updates),
             str(tmp_path / 'logs')],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out)
    return procs, outs


def test_two_process_train_and_restart_resume(tmp_path):
    port = _free_port()
    # phase 1: 3 updates (N=8 * T=16 * 3)
    procs, outs = _launch(tmp_path, port, 8 * 16 * 3)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    assert 'WORKER0 DONE updates=3' in outs[0], outs[0][-2000:]
    xpid_dir = tmp_path / 'logs' / 'mh_test'
    assert (xpid_dir / 'model.tar').exists()
    assert (xpid_dir / 'logs.csv').exists()
    assert (xpid_dir / 'meta.json').exists()
    # single-writer: rank 1 must not print the progress lines
    assert 'u1/' in outs[0] and 'u1/' not in outs[1]

    # phase 2: RESTART both processes, resume from the checkpoint, run to 5
    port = _free_port()
    procs, outs = _launch(tmp_path, port, 8 * 16 * 5)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    assert 'Resumed from update 3' in outs[0], outs[0][-2000:]
    assert 'Resumed from update 3' in outs[1], outs[1][-2000:]
    assert 'WORKER0 DONE updates=5' in outs[0], outs[0][-2000:]
    # logs.csv should cover all 5 updates without duplicate ticks
    rows = (xpid_dir / 'logs.csv').read_text().strip().splitlines()
    ticks = [r.split(',')[0] for r in rows[1:]]
    assert len(ticks) == len(set(ticks)), ticks
