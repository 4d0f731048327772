"""utils/checkpoint.py: the key-path -> array checkpoint format."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dcd_isaac_tpu.algos.ppo import AgentTrainState
from dcd_isaac_tpu.utils import struct
from dcd_isaac_tpu.utils.checkpoint import (
    CHECKPOINT_FORMAT, load_agent_finetune, load_checkpoint, save_checkpoint,
)


@struct.dataclass
class State:
    rng: jax.Array
    agent: AgentTrainState
    extra: object


def make_state(seed):
    k = jax.random.PRNGKey(seed)
    params = {'params': {'dense': {'kernel': jax.random.normal(k, (3, 2)),
                                   'bias': jnp.arange(2.0)}}}
    agent = AgentTrainState(params=params, opt_state=(jnp.int32(seed),),
                            popart=None)
    return State(rng=k, agent=agent, extra={'count': jnp.full((4,), seed)})


def assert_trees_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype


def test_save_load_roundtrip(tmp_path):
    path = str(tmp_path / 'model.tar')
    state = make_state(7)
    save_checkpoint(path, state, {'num_updates': 3})
    restored, host = load_checkpoint(path, make_state(0))
    assert host == {'num_updates': 3}
    assert_trees_equal(restored, state)
    with open(path, 'rb') as f:
        payload = pickle.load(f)
    assert payload['format'] == CHECKPOINT_FORMAT
    assert ".agent.params['params']['dense']['kernel']" in payload['state']


def test_finetune_reads_agent_subtree(tmp_path):
    path = str(tmp_path / 'model.tar')
    state = make_state(5)
    save_checkpoint(path, state, {})
    agent = load_agent_finetune(path, make_state(0).agent)
    assert_trees_equal(agent, state.agent)


def test_old_msgpack_checkpoint_fails_clearly(tmp_path):
    path = str(tmp_path / 'model.tar')
    with open(path, 'wb') as f:
        pickle.dump({'pytree': b'\x81\xa3rng', 'host': {},
                     'level_encoding': 2}, f)
    with pytest.raises(ValueError, match='checkpoint format 1'):
        load_checkpoint(path, make_state(0))
    with pytest.raises(ValueError, match='checkpoint format 1'):
        load_agent_finetune(path, make_state(0).agent)


def test_mismatched_template_fails(tmp_path):
    path = str(tmp_path / 'model.tar')
    save_checkpoint(path, make_state(1), {})
    bigger = make_state(0).replace(extra={'count': jnp.zeros(5)})
    with pytest.raises(ValueError, match='shape'):
        load_checkpoint(path, bigger)
    other = make_state(0).replace(extra={'other': jnp.zeros(4)})
    with pytest.raises(KeyError, match='other'):
        load_checkpoint(path, other)
