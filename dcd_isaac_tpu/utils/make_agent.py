"""Model factory (reference util/make_agent.py:15-244).

Dispatches on env family and agent role ('agent' | 'adversary_agent' |
'adversary_env') with the reference's hyperparameters.
"""

from __future__ import annotations

from ..envs.registry import env_family
from ..models.multigrid_models import (
    MultigridGlobalCriticNetwork, MultigridNetwork,
)


def resolve_bf16(args) -> bool:
    """--bf16 three-state: True / False / None (auto = bf16 on any
    accelerator backend, f32 on CPU)."""
    v = getattr(args, 'bf16', None)
    if v is None:
        import jax
        v = jax.default_backend() != 'cpu'
    return bool(v)


def make_model(args, env, agent_type: str):
    family = env_family(args.env_name)
    # --bf16: model compute in bfloat16 (params/losses/heads stay float32);
    # meant to halve memory traffic and take the bf16 tensor-core path for
    # the hot teacher conv128→LSTM input projection (chosen on the earlier
    # pre-GPU build; not yet measured on the H100, ROADMAP C3)
    import jax.numpy as jnp
    dtype = jnp.bfloat16 if resolve_bf16(args) else jnp.float32
    if family == 'multigrid':
        if agent_type == 'adversary_env':
            recurrent = (args.recurrent_arch
                         if args.recurrent_adversary_env else None)
            return MultigridNetwork(
                num_actions=env.adversary_num_actions,
                conv_filters=128,
                scalar_fc=10,
                scalar_dim=env.params.adversary_max_steps + 1,
                random_z_dim=env.params.random_z_dim,
                recurrent_arch=recurrent,
                recurrent_hidden_size=args.recurrent_hidden_size,
                dtype=dtype)
        recurrent = args.recurrent_arch if args.recurrent_agent else None
        kwargs = dict(
            num_actions=env.num_actions,
            scalar_fc=5,
            scalar_dim=4,
            recurrent_arch=recurrent,
            recurrent_hidden_size=args.recurrent_hidden_size,
            dtype=dtype)
        if args.use_global_critic or args.use_global_policy:
            return MultigridGlobalCriticNetwork(
                use_global_policy=args.use_global_policy, **kwargs)
        return MultigridNetwork(**kwargs)
    if family == 'walker':
        from ..models.walker_models import make_walker_model
        return make_walker_model(args, env, agent_type)
    if family == 'carracing':
        from ..models.car_racing_models import make_carracing_model
        return make_carracing_model(args, env, agent_type)
    raise ValueError(family)


def make_all_models(args, env):
    models = {'agent': make_model(args, env, 'agent')}
    if args.ued_algo in ('paired', 'flexible_paired'):
        models['adversary_agent'] = make_model(args, env, 'adversary_agent')
    if args.ued_algo in ('paired', 'flexible_paired', 'minimax'):
        models['adversary_env'] = make_model(args, env, 'adversary_env')
    return models
