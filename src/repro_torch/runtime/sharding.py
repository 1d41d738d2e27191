"""Sharding rules: the solver fleet's part.

The JAX package's module also holds the parameter, state and input
sharding rules of training and serving (``param_spec``,
``param_shardings``, ``state_shardings``, ``input_shardings``,
``shard_params``, ``batch_axes``, ``logical_batch_spec``); they come with
training (ROADMAP, Queue A item 14).

``solve_batch_spec`` has no counterpart.  It returns a JAX
``PartitionSpec`` that tells ``shard_map`` to split a solve batch's
leading axis over the fleet; PyTorch has no such object.  Here the layout
is the shard plan itself (``repro_torch.core.mcop_shard.shard_plan``):
its ``perm`` puts shard ``s``'s rows in the ``s``-th contiguous block of
the permuted batch, and the dispatcher hands that block to
``mesh.devices[s]``.
"""

from __future__ import annotations

__all__ = ["SOLVE_AXIS", "solver_axis", "solver_shards"]

# canonical axis name of a dedicated solver mesh (launch.mesh.make_solver_mesh)
SOLVE_AXIS = "solve"


def solver_axis(mesh) -> str:
    """The mesh axis a solve batch shards over: ``"solve"`` when the mesh
    has it, else its first axis."""
    names = mesh.axis_names
    return SOLVE_AXIS if SOLVE_AXIS in names else names[0]


def solver_shards(mesh) -> int:
    """Device count along the solver axis (the fleet's shard count)."""
    return len(mesh.devices)
