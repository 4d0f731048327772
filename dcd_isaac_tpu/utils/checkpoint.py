"""Atomic checkpointing of the full runner state.

Reference semantics (util/__init__.py:59-69 + adversarial_runner
state_dict): single-writer tmp-then-replace atomic writes, `_index` archive
copies, and the curriculum state (PLR buffers) saved alongside model/optimizer
state so training is fully resumable.

The file is a pickle of a dict. Its ``'state'`` entry maps each leaf's key
path in the RunnerState pytree (``jax.tree_util.keystr``) to a numpy array;
device arrays are pulled to host once per checkpoint.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional

import jax
import numpy as np


def _gather_to_host(runner_state: Any):
    """Pull the full state to host memory.

    Single-host: plain device_get.  Multi-host: sharded leaves are not
    fully addressable, so each is first re-laid-out fully replicated (an
    all-gather across hosts executed by EVERY process — call
    this from all ranks) and the local replica is read.
    """
    if jax.process_count() == 1:
        return jax.device_get(runner_state)
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec

    def pull(x):
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            mesh = x.sharding.mesh
            rep = jax.jit(
                lambda a: a,
                out_shardings=NamedSharding(mesh, PartitionSpec()))(x)
            return np.asarray(rep)
        return np.asarray(x) if isinstance(x, jax.Array) else x

    return jax.tree.map(pull, runner_state)


# Walker/CarRacing level vectors carry a terrain seed in a float32 lane.
# Encoding v2 = value-cast of a [0, 2^24) seed (envs/seeds.py); v1 (early
# round 4) bitcast raw uint32 bits, which a v2 reader silently misdecodes
# (~50% of seeds collapse to 0/1, NaN patterns cast UB). Checkpoints record
# the version so resuming a stale run fails loudly instead.
LEVEL_ENCODING_VERSION = 2
_SEEDED_LEVEL_FAMILIES = ('Walker', 'CarRacing')

# Payload layout. Format 2 stores the key-path -> array dict under 'state';
# files without a 'format' field hold flax msgpack bytes under 'pytree',
# which this build cannot read.
CHECKPOINT_FORMAT = 2


def _check_format(payload: dict, path: str):
    fmt = payload.get('format', 1)
    if fmt != CHECKPOINT_FORMAT:
        raise ValueError(
            f'{path} is checkpoint format {fmt} (flax msgpack); this build '
            f'reads format {CHECKPOINT_FORMAT} (key-path -> array dict) '
            'only. Restart the run from scratch.')


def _to_arrays(state: Any) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _from_arrays(template: Any, arrays: dict, prefix: str = ''):
    """Rebuild ``template``'s structure from the stored arrays whose keys
    are ``prefix`` + each leaf's key path."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    for p, leaf in leaves:
        key = prefix + jax.tree_util.keystr(p)
        if key not in arrays:
            raise KeyError(f'checkpoint has no entry {key}')
        a = arrays[key]
        if a.shape != np.shape(leaf):
            raise ValueError(f'checkpoint entry {key} has shape {a.shape}, '
                             f'expected {np.shape(leaf)}')
        out.append(a)
    return jax.tree_util.tree_unflatten(treedef, out)


def save_checkpoint(path: str, runner_state: Any, host_state: dict):
    """Atomic write of (pytree bytes, host counters).

    Multi-host: every process must call this (the gather is collective);
    only process 0 writes the file, and all ranks synchronize after so a
    subsequent resume never reads a half-written checkpoint.
    """
    state = _gather_to_host(runner_state)
    if jax.process_index() == 0:
        payload = {
            'format': CHECKPOINT_FORMAT,
            'state': _to_arrays(state),
            'host': host_state,
            'level_encoding': LEVEL_ENCODING_VERSION,
        }
        tmp = path + '.tmp'
        with open(tmp, 'wb') as f:
            pickle.dump(payload, f)
        os.replace(tmp, path)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices('dcd_checkpoint_saved')


def load_checkpoint(path: str, template: Any, env_name: Optional[str] = None):
    """Restore into the structure of ``template`` → (runner_state, host).

    ``env_name`` (when given) enables the level-encoding version check for
    families whose PLR buffers store float-encoded terrain seeds.
    """
    with open(path, 'rb') as f:
        payload = pickle.load(f)
    # the encoding check comes first: a pre-v2 file is also pre-format-2,
    # and the encoding message is the one that says what went wrong
    if env_name and any(f in env_name for f in _SEEDED_LEVEL_FAMILIES):
        ver = payload.get('level_encoding', 1)
        if ver != LEVEL_ENCODING_VERSION and not os.environ.get(
                'DCD_ALLOW_STALE_LEVEL_ENCODING'):
            raise ValueError(
                f'{path} predates the level-encoding version field '
                f'(treated as v{ver}); this build reads '
                f'v{LEVEL_ENCODING_VERSION} (value-cast seeds) and cannot '
                'tell whether the stored PLR buffer uses the old bitcast '
                'encoding, which it would silently misdecode. Restart the '
                'run, or set DCD_ALLOW_STALE_LEVEL_ENCODING=1 to resume '
                'anyway (safe IF the run was trained on value-cast code).')
    _check_format(payload, path)
    return _from_arrays(template, payload['state']), payload['host']


def load_agent_finetune(path: str, agent_template: Any):
    """Extract ONLY the student agent train state from a checkpoint.

    Fine-tuning init (reference train.py:112-141): loads the base run's
    agent model + optimizer, leaving everything else (teacher, PLR buffers,
    counters) fresh — so the base run's config need not match the new one.
    """
    with open(path, 'rb') as f:
        payload = pickle.load(f)
    _check_format(payload, path)
    return _from_arrays(agent_template, payload['state'], prefix='.agent')


def archive_path(base_path: str, index: int) -> str:
    root, ext = os.path.splitext(base_path)
    return f'{root}_{index}{ext}'
