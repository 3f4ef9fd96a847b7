"""Device seats and data-parallel helpers: the port's SPMD toolkit.

Port of the JAX package's ``parallel/mesh.py``.  The reference has one
distributed axis that matters: data-parallel batch sharding with an
associative combine (the rayon chunk-AND-reduce of
block_signature_verifier.rs:396-405).  It is single-controller: one process
drives every device through ``shard_map`` over a ``Mesh`` of
``jax.devices()``.  So is the port, without ``torch.distributed``:

* ``Mesh`` is a frozen, hashable tuple of seats (``torch.device``s) and an
  axis name.  A seat may repeat a device: ``make_mesh(8, device="cpu")``
  is the counterpart of the reference's 8 virtual CPU devices
  (``--xla_force_host_platform_device_count=8``), and
  ``make_mesh(2, device="cuda:0")`` runs a width-2 mesh on one card.
* ``seat_context(device)`` makes a seat's device the current one
  (``torch.cuda.device`` on CUDA, nothing on the CPU): the kernels' ctypes
  launchers go to the current device, so every seat's work runs under it.
* A collective is an explicit function over the list of the seats'
  partials: peer copies, then a cat (``allgather_tree``), an AND
  (``and_reduce``) or a ring fold (``ring_reduce``).
* ``dp_shard_map(local_fn, mesh, combine)`` splits every operand leaf on
  its trailing (batch) axis, runs ``local_fn`` on each seat's columns under
  its ``seat_context`` and hands the list of partials to ``combine``.

One thing differs from ``shard_map`` by design: in JAX ``local_fn`` ends
with its own collective, which every device reaches together.  Here the
seats run one after another from one host thread, their work enqueued
without waiting, so a collective inside ``local_fn`` would need a
rendezvous that never comes.  The combine is therefore a second step, over
the partials of every seat.

The reference's ``compat_shard_map`` and ``compat_jit_sharded`` are shims
across jax versions (``check_vma`` / ``check_rep``, ``jit`` / ``pjit``);
they have no counterpart here.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

BATCH_AXIS = "batch"


class PartitionSpec(tuple):
    """Per-dimension placement of one operand: the axis name on the dimension
    the mesh splits, None elsewhere; ``PartitionSpec()`` replicates.  A
    tuple, told apart from the operand trees' own tuples by its type (the
    counterpart of ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: one seat per shard, in shard order."""

    seats: tuple
    axis: str = BATCH_AXIS

    def __post_init__(self):
        object.__setattr__(self, "seats", tuple(torch.device(s) for s in self.seats))
        if not self.seats:
            raise ValueError("a mesh needs at least one seat")

    @property
    def width(self) -> int:
        return len(self.seats)

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.seats)}

    @property
    def lead(self) -> torch.device:
        """The seat a replicated epilogue runs on (the first)."""
        return self.seats[0]


def make_mesh(n_devices: int | None = None, axis: str = BATCH_AXIS, device=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` CUDA devices (all visible by
    default); it raises when fewer are visible.  With ``device``, ``n_devices``
    seats (1 by default) on that one device: the virtual mesh."""
    if device is not None:
        return Mesh(tuple(torch.device(device) for _ in range(n_devices or 1)), axis)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    if n < 1 or have < n:
        raise RuntimeError(f"need {max(n, 1)} CUDA devices, have {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


def seat_context(device):
    """The context a seat's work runs in: its device made current on CUDA
    (the kernels launch on the current device), nothing on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def batch_spec(ndim: int, axis_pos: int = -1, axis: str = BATCH_AXIS) -> PartitionSpec:
    """The spec of an ``ndim`` operand split on one axis; scalars (ndim 0)
    are replicated."""
    if ndim == 0:
        return PartitionSpec()
    pos = axis_pos % ndim
    return PartitionSpec(*[axis if i == pos else None for i in range(ndim)])


# ---------------------------------------------------------------------------
# Operand trees: tensors, LFp-shaped leaves (``.limbs`` and ``.bound``) and
# tuples of them
# ---------------------------------------------------------------------------


def _is_lfp(x) -> bool:
    return hasattr(x, "limbs") and hasattr(x, "bound")


def map_tree(fn, tree):
    """``fn`` on every tensor of a tree; LFp leaves keep their bound."""
    if _is_lfp(tree):
        return type(tree)(fn(tree.limbs), tree.bound)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return tuple(map_tree(fn, t) for t in tree)
    return tree


def zip_trees(fn, trees):
    """``fn`` on the list of matching tensors of same-structure trees; an LFp
    leaf's bound is the largest of its inputs'."""
    first = trees[0]
    if _is_lfp(first):
        return type(first)(fn([t.limbs for t in trees]), max(t.bound for t in trees))
    if isinstance(first, torch.Tensor):
        return fn(list(trees))
    return tuple(zip_trees(fn, [t[i] for t in trees]) for i in range(len(first)))


def tree_leaves(tree) -> list:
    if _is_lfp(tree):
        return [tree.limbs]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return []


def tree_device(tree) -> torch.device:
    return tree_leaves(tree)[0].device


def host_pinned(t: torch.Tensor) -> torch.Tensor:
    """A host tensor as a contiguous pinned one (itself when it is one, and
    any other tensor as it is): a copy to a card from it neither blocks nor
    waits, where one from a strided or pageable host tensor would."""
    if t.device.type != "cpu" or (t.is_pinned() and t.is_contiguous()):
        return t
    return t.contiguous().pin_memory()


def to_seat(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device`` without a host sync: a copy between devices is a
    peer copy on the current stream, a host tensor goes through contiguous
    pinned memory (``host_pinned``)."""
    device = torch.device(device)
    if t.device == device:
        return t
    if device.type == "cuda":
        t = host_pinned(t)
    return t.to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# Collectives over the seats' partials
# ---------------------------------------------------------------------------


def allgather_tree(parts, device=None):
    """Gather the seats' partials (one tree each, batch on the trailing axis)
    into one tree on ``device`` (the first partial's device by default), the
    seats' columns in seat order: the combine for small per-seat partials."""
    device = tree_device(parts[0]) if device is None else torch.device(device)
    return zip_trees(lambda xs: torch.cat([to_seat(x, device) for x in xs], dim=-1), parts)


def and_reduce(oks, device=None):
    """The global conjunction of the seats' booleans, a one-element bool
    tensor on ``device`` (the first one's device by default)."""
    device = oks[0].device if device is None else torch.device(device)
    return torch.cat([to_seat(o.reshape(-1), device) for o in oks]).all().reshape(1)


def ring_reduce(parts, combine, seats=None):
    """Ring reduction of the seats' partials with an associative
    ``combine(acc, incoming)``, in the reference's order: N - 1 hops, seat i
    sending to seat i + 1 at each, each seat folding what it receives into
    its accumulator under its ``seat_context``.  Returns the accumulators,
    one per seat: after the last hop every seat holds the full product (the
    ring-attention accumulation, SURVEY section 2.8).  ``seats`` defaults to
    each partial's device."""
    n = len(parts)
    seats = [tree_device(p) for p in parts] if seats is None else list(seats)
    acc, incoming = list(parts), list(parts)
    for _ in range(n - 1):
        incoming = [map_tree(lambda x, d=seats[j]: to_seat(x, d), incoming[(j - 1) % n])
                    for j in range(n)]
        for j in range(n):
            with seat_context(seats[j]):
                acc[j] = combine(acc[j], incoming[j])
    return acc


def shard_tree(tree, mesh: Mesh, trailing_batch: bool = True) -> list:
    """Split every leaf of ``tree`` into ``mesh.width`` equal contiguous
    pieces on its trailing axis (or its first), piece i placed on seat i.
    The extent must divide by the width, as ``shard_map`` requires."""
    width = mesh.width
    leaves = tree_leaves(tree)
    dim = -1 if trailing_batch else 0
    extent = int(leaves[0].shape[dim])
    if extent % width:
        raise ValueError(f"batch extent {extent} does not divide by the mesh width {width}")
    size = extent // width

    def piece(i):
        def cut(x):
            x = x[..., i * size:(i + 1) * size] if trailing_batch else x[i * size:(i + 1) * size]
            return to_seat(x, mesh.seats[i])

        with seat_context(mesh.seats[i]):
            return map_tree(cut, tree)

    return [piece(i) for i in range(width)]


def dp_shard_map(local_fn, mesh: Mesh, combine, axis: str = BATCH_AXIS,
                 trailing_batch: bool = True):
    """``local_fn`` data-parallel over ``mesh``: every operand leaf is split
    on its trailing axis (the batch convention: limb planes (26, B), bit
    planes (64, B)), seat i runs ``local_fn`` on its columns under its
    ``seat_context``, and ``combine(partials)`` reduces the list of the
    seats' outputs to the result.  The combine is an explicit second step:
    the seats run one after another from this thread (see the module
    docstring)."""
    if axis != mesh.axis:
        raise ValueError(f"mesh axis {mesh.axis!r}, not {axis!r}")

    def wrapped(*args):
        shards = shard_tree(args, mesh, trailing_batch)
        partials = []
        for seat, shard in zip(mesh.seats, shards):
            with seat_context(seat):
                partials.append(local_fn(*shard))
        return combine(partials)

    return wrapped
