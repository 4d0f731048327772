"""Device-mesh utilities for SPMD scale-out.

The DCD workload is an actor-learner fused program whose natural parallel
axis is the env batch (SURVEY.md §2.9): envs, rollouts and PPO minibatches
shard over a 'dp' mesh axis; model params and PLR buffers are replicated
(models are <1M params; the buffer is read-mostly).  XLA inserts psum /
all-gather collectives over the device interconnect (NVLink between the
GPUs of one host) for the gradient reduction and the global minibatch
permutations.

TP/PP/SP/EP axes are not needed for parity with the reference (no large
matmuls, no attention; SURVEY.md §5.7) — the mesh is built with named axes so
additional axes can be introduced without restructuring.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = 'dp') -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis_name,))


def parse_mesh_shape(spec: str):
    """'dp:8' / 'dp:4,tp:2' / 'dp:-1' → (names, sizes); -1 = all remaining
    devices (at most one -1)."""
    names, sizes = [], []
    for part in spec.split(','):
        name, _, size = part.partition(':')
        names.append(name.strip())
        sizes.append(int(size) if size else -1)
    assert sizes.count(-1) <= 1, f'at most one -1 axis in {spec!r}'
    n_dev = len(jax.devices())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = max(n_dev // known, 1)
    return tuple(names), tuple(sizes)


def make_mesh_from_spec(spec: str) -> Mesh:
    """Build a device mesh from a --mesh_shape CLI spec (e.g. 'dp:8')."""
    names, sizes = parse_mesh_shape(spec)
    total = int(np.prod(sizes))
    devs = jax.devices()
    assert total <= len(devs), (
        f'mesh {spec!r} needs {total} devices, have {len(devs)}')
    return Mesh(np.asarray(devs[:total]).reshape(sizes), names)


def place_runner_state(state, mesh: Mesh, num_processes: int,
                       axis_name: str = 'dp'):
    """Shard the env-batch leaves of a RunnerState over ``axis_name``.

    Leaves with a leading (or second, for (T, N, …) rollout buffers) axis of
    size ``num_processes`` shard on that axis; params / optimizer state /
    PLR buffers replicate.  The reference's equivalent subsystem is its
    subprocess vec-env fan-out (envs/wrappers/parallel_wrappers.py:103-137).
    """
    N = num_processes
    n = int(np.prod([mesh.shape[a] for a in (axis_name,)]))
    multihost = jax.process_count() > 1

    def put(x):
        if not hasattr(x, 'ndim'):
            return x
        if multihost and isinstance(x, jax.Array):
            # global placement needs a host value identical on all ranks
            # (state is derived deterministically from the seed, so it is)
            x = np.asarray(x)
        if x.ndim == 1 and x.shape == (2,) and x.dtype == jnp.uint32:
            # raw PRNG key — always replicated
            return jax.device_put(x, NamedSharding(mesh, P()))
        if x.ndim >= 1 and x.shape[0] == N and N % n == 0:
            return jax.device_put(x, NamedSharding(mesh, P(axis_name)))
        if x.ndim >= 2 and x.shape[1] == N and N % n == 0 \
                and x.shape[0] != N:
            return jax.device_put(
                x, NamedSharding(mesh, P(None, axis_name)))
        return jax.device_put(x, NamedSharding(mesh, P()))

    return jax.tree.map(put, state)


def placement_summary(tree) -> dict:
    """{number of devices a leaf spans: number of such leaves} over the
    array leaves of ``tree`` — shows whether any leaf sits whole on one
    device of a mesh."""
    counts: dict = {}
    for x in jax.tree.leaves(tree):
        if isinstance(x, jax.Array):
            n = len(x.sharding.device_set)
            counts[n] = counts.get(n, 0) + 1
    return counts


def shard_batch(tree, mesh: Mesh, axis_name: str = 'dp'):
    """Place every leaf with a leading batch axis on the mesh, sharded on
    that axis; scalars/replicated leaves get full replication."""
    n = mesh.devices.size

    def put(x):
        if hasattr(x, 'ndim') and x.ndim >= 1 and x.shape[0] % n == 0:
            return jax.device_put(x, NamedSharding(mesh, P(axis_name)))
        return jax.device_put(x, NamedSharding(mesh, P()))

    return jax.tree.map(put, tree)


def replicate(tree, mesh: Mesh):
    return jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), tree)
