"""chip_smoke.py refuses to report without a GPU; the training path needs
no flax."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_smoke(cwd, script):
    env = {**os.environ, 'JAX_PLATFORMS': 'cpu'}
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          text=True, capture_output=True, timeout=300)


def test_no_gpu_exits_nonzero_without_result():
    out = run_smoke(ROOT, os.path.join(ROOT, 'chip_smoke.py'))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert 'GPU' in out.stderr


def test_script_alone_fails(tmp_path):
    script = str(tmp_path / 'chip_smoke.py')
    shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), script)
    out = run_smoke(str(tmp_path), script)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert os.listdir(tmp_path) == ['chip_smoke.py']


def test_tiny_train_runs_with_flax_blocked(tmp_path):
    code = (
        'import sys\n'
        "sys.modules['flax'] = None   # any flax import now fails\n"
        'from dcd_isaac_tpu.train import main\n'
        "main(['--env_name', 'MultiGrid-MiniAdversarial-v0',\n"
        "      '--ued_algo', 'paired', '--num_processes', '2',\n"
        "      '--num_steps', '4', '--ppo_epoch', '1',\n"
        "      '--num_env_steps', '8', '--test_interval', '0',\n"
        "      '--checkpoint', 'true', '--log_dir', sys.argv[1],\n"
        "      '--xpid', 'noflax'])\n"
        "assert sys.modules['flax'] is None\n"
        "print('TRAINED')\n")
    env = {**os.environ, 'JAX_PLATFORMS': 'cpu', 'PYTHONPATH': ROOT}
    out = subprocess.run([sys.executable, '-c', code, str(tmp_path)],
                         cwd=str(tmp_path), env=env, text=True,
                         capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'TRAINED' in out.stdout
    assert os.path.isfile(tmp_path / 'noflax' / 'model.tar')


def test_numerics_summary_rules():
    import chip_smoke
    ok = ('....\n=== short test summary info ===\n'
          "SKIPPED [1] tests/test_gym_bipedal_terrain.py:19: could not "
          "import 'gymnasium': No module named 'gymnasium'\n"
          '31 passed, 1 skipped, 268 deselected in 178.26s (0:02:58)\n')
    assert chip_smoke.numerics_problem(ok) is None
    failed = '..F\n30 passed, 1 failed, 268 deselected in 170.00s\n'
    assert '1 failed' in chip_smoke.numerics_problem(failed)
    chip_skip = ('sss\nSKIPPED [3] tests/test_chip.py:92: chip test: needs a '
                 "GPU, JAX found 'cpu'\n3 skipped, 268 deselected in 1.0s\n")
    assert 'no chip test passed' in chip_smoke.numerics_problem(chip_skip)
    some_skip = ('..s\nSKIPPED [1] tests/test_chip.py:92: chip test: needs '
                 "a GPU, JAX found 'cpu'\n2 passed, 1 skipped in 1.0s\n")
    assert 'skipped' in chip_smoke.numerics_problem(some_skip)
