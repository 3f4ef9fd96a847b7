"""Data-parallel verification over device seats: the mesh, the rule-driven
sharded program (``partition``) and the pod-scale verifier with per-shard
fault domains (``pod``).

The port of the JAX package's ``parallel`` package.  The reference is
single-controller: one process drives every device through ``shard_map``
over a ``Mesh``.  Here, too, one process drives every seat: a mesh is a
tuple of ``torch.device`` seats (a device may repeat), each seat runs its own
backend's keyed program, and a collective is an explicit function over the
seats' partials.  ``partition`` and ``pod`` are imported by their
consumers; only the mesh helpers are re-exported here.
"""

from .mesh import (  # noqa: F401
    BATCH_AXIS,
    Mesh,
    PartitionSpec,
    allgather_tree,
    and_reduce,
    batch_spec,
    dp_shard_map,
    make_mesh,
    ring_reduce,
    seat_context,
)
