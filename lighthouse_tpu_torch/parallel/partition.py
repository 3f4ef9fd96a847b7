"""Rule-driven operand placement: the sharded verification program.

Port of the JAX package's ``parallel/partition.py``.  The whole marshalled
operand tree is placed by one literal regex -> spec rule table, each seat
verifies its batch columns, and only a ``(width,)`` bool vector of per-seat
verdicts returns to the host.  The pieces, bottom-up:

* **leaf naming**: ``named_operand_leaves`` walks a marshalled operand tuple
  (``MarshalledBatch.args``) and names every limb plane with a stable
  ``/``-joined path (``pk/x/limbs``, ``sig/y/c1/limbs``, ``wbits``, ...).
  The canonical inventory is the literal ``OPERAND_LEAVES`` tuple.
* **rule matching**: ``match_partition_rules`` maps each leaf name to a spec
  by the first ``re.search`` match over the literal ``PARTITION_RULES``
  (scalars replicate; an unmatched leaf is an error).  ``batch`` splits the
  trailing batch axis, ``registry`` the validator axis of the pubkey
  registry, ``replicated`` copies a constant to every seat.
* **shard/gather fns**: ``make_shard_and_gather_fns`` gives per-leaf
  functions that slice a seat's columns and place them on the seat without
  a host sync (pinned host memory, or a peer copy), and that gather the
  pieces back to the host.
* **the program**: :class:`ShardedVerifyProgram` runs, on each seat under
  its ``seat_context``, either a plain ``local_verify_fn`` eagerly (stub
  kernels, the CPU) or the backend's keyed program for the seat's batch
  (``TorchBackend.seat_program``: on the card one CUDA graph per key, at
  ``B / width``).  The seats' one-element verdicts are gathered onto the
  lead seat as the ``(width,)`` verdict vector; a False at index i condemns
  only ``shard_bounds(total)[i]``.
* **partitioned-registry gather**: in registry mode the pubkey operand never
  exists on the host.  Each seat holds a contiguous validator-axis shard of
  the registry (``PubkeyLimbCache.registry_device_sharded``) and the batch's
  whole ``(B,)`` slot vector; it takes the columns it owns with
  ``index_select`` (other slots masked to zero), the seats' ``(26, B)``
  planes are summed onto every seat (the reference's ``psum``, exact since
  one seat hits each slot), and each seat slices its own columns.
* **epoch streaming**: :func:`stream_epoch` drives chunks of sets through
  the program with ``inflight`` chunks in flight, so an epoch's operands
  never sit on the host at once.

The reference builds one ``shard_map`` program per operand structure and
gathers the verdicts with a collective inside it.  Here the seats run one
after another from one host thread, their work enqueued without waiting,
so the gather of the verdicts and the registry's sum are explicit steps
between the seats' work (``parallel/mesh.py``).  This module imports no
field code: the pubkey wrap for registry gathers is injected
(``pk_wrap``), so it runs with stub kernels.
"""

from __future__ import annotations

import re
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from . import mesh as _mesh
from .mesh import BATCH_AXIS, PartitionSpec, map_tree, to_seat, tree_leaves

AXIS = BATCH_AXIS


# ---------------------------------------------------------------------------
# The rule table (literal on purpose: the reference's lint parses its twin)
# ---------------------------------------------------------------------------

# token -> PartitionSpec factory (ndim, axis)
SPEC_TOKENS = {
    "batch": lambda ndim, axis: PartitionSpec(*([None] * (ndim - 1)), axis),
    "registry": lambda ndim, axis: PartitionSpec(None, axis),
    "replicated": lambda ndim, axis: PartitionSpec(),
}

# First-re.search-match-wins, top to bottom.  Every live operand leaf
# must be claimed by exactly one rule (orphans and dead/shadowed rules
# are lint findings):
#   registry/(x|y)  the (26, n_validators) pubkey mirror — split on the
#                   VALIDATOR axis, the one operand that must never be
#                   replicated (26 x 1M x 4 B = 104 MB/device otherwise)
#   slots           (B,) validator-slot vector — batch-sharded like the
#                   work it indexes
#   wbits           (64, B) random-weight bit planes — batch-sharded
#   .../limbs       every field-element limb plane (pk/sig/h/u0/u1
#                   coordinates, (26, B)) — batch-sharded
PARTITION_RULES = (
    (r"^registry/(x|y)$", "registry"),
    (r"^slots$", "batch"),
    (r"^wbits$", "batch"),
    (r"/limbs$", "batch"),
)

# Canonical operand-leaf inventory across every program mode (h2c /
# host-h2c / partitioned-registry).  The runtime test binds this to the
# live marshal output; the lint proves rule-table coverage over it.
OPERAND_LEAVES = (
    "pk/x/limbs",
    "pk/y/limbs",
    "sig/x/c0/limbs",
    "sig/x/c1/limbs",
    "sig/y/c0/limbs",
    "sig/y/c1/limbs",
    "h/x/c0/limbs",
    "h/x/c1/limbs",
    "h/y/c0/limbs",
    "h/y/c1/limbs",
    "u0/c0/limbs",
    "u0/c1/limbs",
    "u1/c0/limbs",
    "u1/c1/limbs",
    "wbits",
    "registry/x",
    "registry/y",
    "slots",
)


def mesh_width(mesh) -> int:
    """Seat count of a mesh (the product of its axis sizes)."""
    width = 1
    for n in mesh.shape.values():
        width *= int(n)
    return width


# ---------------------------------------------------------------------------
# Operand naming: marshalled tuple -> (name, leaf) pairs
# ---------------------------------------------------------------------------

# nested-tuple labels per top-level operand, by depth: G1 points are
# (x, y) coordinate pairs, G2/fp2 values nest (c0, c1) components.
_NEST_LABELS = {
    "pk": (("x", "y"),),
    "sig": (("x", "y"), ("c0", "c1")),
    "h": (("x", "y"), ("c0", "c1")),
    "u0": (("c0", "c1"),),
    "u1": (("c0", "c1"),),
}

# positional -> semantic top names, keyed by (deferred_pk, len(args)).
# Deferred-pk tuples are registry mode: the pubkey operand is gathered
# inside the program from the partitioned registry, so args skip it.
_TOP_NAMES = {
    (False, 5): ("pk", "sig", "u0", "u1", "wbits"),
    (False, 4): ("pk", "sig", "h", "wbits"),
    (True, 4): ("sig", "u0", "u1", "wbits"),
    (True, 3): ("sig", "h", "wbits"),
}


def _is_lfp(x) -> bool:
    return hasattr(x, "limbs") and hasattr(x, "bound")


def _walk(top: str, x, depth: int, prefix: str, out: list) -> None:
    if _is_lfp(x):
        out.append((prefix + "/limbs", x.limbs))
    elif isinstance(x, (tuple, list)):
        levels = _NEST_LABELS.get(top, ())
        labels = (levels[depth] if depth < len(levels)
                  else tuple(str(i) for i in range(len(x))))
        for lbl, e in zip(labels, x):
            _walk(top, e, depth + 1, prefix + "/" + lbl, out)
    else:
        out.append((prefix, x))


def named_operand_leaves(args, *, deferred_pk: bool = False) -> list:
    """``[(leaf_name, tensor)]`` in flatten order for a marshalled operand
    tuple (``MarshalledBatch.args``)."""
    key = (bool(deferred_pk), len(args))
    tops = _TOP_NAMES.get(key)
    if tops is None:
        raise ValueError(f"unrecognized operand tuple shape: {key}")
    out: list = []
    for top, a in zip(tops, args):
        _walk(top, a, 0, top, out)
    return out


# ---------------------------------------------------------------------------
# Rule matching + shard/gather fns
# ---------------------------------------------------------------------------


def _ndim_numel(leaf) -> tuple[int, int]:
    if isinstance(leaf, torch.Tensor):
        return leaf.dim(), leaf.numel()
    return int(np.ndim(leaf)), int(np.size(leaf))


def match_partition_rules(rules, named_leaves, axis: str = AXIS) -> list:
    """Leaf name -> PartitionSpec by first ``re.search`` match over
    ``rules``; scalar and one-element leaves replicate; an unmatched leaf
    is a hard error (a silent replication would hide exactly the registry
    mistake the table exists to prevent)."""
    specs = []
    for name, leaf in named_leaves:
        ndim, numel = _ndim_numel(leaf)
        if ndim == 0 or numel == 1:
            specs.append(PartitionSpec())
            continue
        for rule, token in rules:
            if re.search(rule, name) is not None:
                specs.append(SPEC_TOKENS[token](ndim, axis))
                break
        else:
            raise ValueError(f"partition rule not found for operand leaf: {name}")
    return specs


def operand_partition_specs(args, *, deferred_pk: bool = False,
                            rules=PARTITION_RULES, axis: str = AXIS):
    """The rule-matched spec tree for a marshalled operand tuple: the
    structure of ``args`` with one PartitionSpec per tensor or LFp node."""
    flat = match_partition_rules(
        rules, named_operand_leaves(args, deferred_pk=deferred_pk), axis)
    it = iter(flat)

    def rebuild(x):
        if _is_lfp(x) or not isinstance(x, (tuple, list)):
            return next(it)
        return tuple(rebuild(e) for e in x)

    return tuple(rebuild(a) for a in args)


def _map_specs(fn, tree):
    """Map over a spec tree with PartitionSpec as the leaf (it is a tuple)."""
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return tuple(_map_specs(fn, t) for t in tree)
    return fn(tree)


def tree_apply(fns, tree):
    """Apply a same-structure tree of per-node callables to an operand
    tree (callables sit at LFp/tensor positions)."""
    if callable(fns):
        return fns(tree)
    return tuple(tree_apply(f, t) for f, t in zip(fns, tree))


class Shards(tuple):
    """One operand leaf placed on a mesh: its piece on each seat, in seat
    order."""


def seat_tree(tree, i: int):
    """Seat ``i``'s operand tree out of a tree whose leaves are ``Shards``."""
    if isinstance(tree, Shards):
        return tree[i]
    if isinstance(tree, (tuple, list)):
        return tuple(seat_tree(t, i) for t in tree)
    return tree


def _split_dim(spec) -> int | None:
    return next((d for d, p in enumerate(spec) if p is not None), None)


def make_shard_and_gather_fns(specs, mesh):
    """Per-leaf (shard_fn, gather_fn) trees from a spec tree.

    ``shard_fn`` slices each seat's piece of a leaf on the spec's split
    axis (the whole leaf for a replicated spec) and places it on the seat
    without a host sync: the next batch's placement overlaps the current
    batch's work.  It returns ``Shards``.  ``gather_fn`` brings the pieces
    back to the host as one tensor.  LFp nodes shard their limb plane and
    keep the static bound."""
    width = mesh_width(mesh)

    def mk_shard(spec):
        dim = _split_dim(spec)

        def place(t, i):
            if dim is not None:
                size = t.shape[dim] // width
                t = t.narrow(dim, i * size, size)
            with _mesh.seat_context(mesh.seats[i]):
                return to_seat(t, mesh.seats[i])

        def shard_fn(x):
            if dim is not None and x_extent(x, dim) % width:
                raise ValueError(f"operand extent {x_extent(x, dim)} on axis {dim} does not "
                                 f"divide by the mesh width {width}")
            return Shards(map_tree(lambda t, i=i: place(t, i), x) for i in range(width))

        return shard_fn

    def mk_gather(spec):
        dim = _split_dim(spec)

        def gather_fn(shards):
            if dim is None:
                return map_tree(lambda t: t.cpu(), shards[0])
            return _mesh.zip_trees(lambda ts: torch.cat([t.cpu() for t in ts], dim=dim),
                                   list(shards))

        return gather_fn

    return _map_specs(mk_shard, specs), _map_specs(mk_gather, specs)


def x_extent(x, dim: int) -> int:
    return int(tree_leaves(x)[0].shape[dim])


# ---------------------------------------------------------------------------
# Padding (dup-of-column-0, the backend marshal contract: AND-safe)
# ---------------------------------------------------------------------------


def _trailing_extent(args) -> int:
    return int(tree_leaves(args)[0].shape[-1])


def _pad_tail(args, pad: int):
    if pad <= 0:
        return args
    return map_tree(
        lambda a: torch.cat([a, a[..., :1].expand(*a.shape[:-1], pad)], dim=-1), args)


def _pad_slots(slots, pad: int) -> torch.Tensor:
    """Pad a (B,) slot vector with duplicates of slot 0, the operand
    columns' contract: a pad lane's gathered pubkey matches its duplicated
    operand column."""
    slots = torch.as_tensor(np.asarray(slots) if not isinstance(slots, torch.Tensor) else slots)
    if pad <= 0:
        return slots
    return torch.cat([slots, slots[:1].expand(pad)])


# ---------------------------------------------------------------------------
# The sharded program
# ---------------------------------------------------------------------------


class ShardedVerifyProgram:
    """One verify over every seat of a mesh, rule-partitioned end to end.

    Each seat verifies its batch columns with one of:

    * ``local_verify_fn(*args) -> bool tensor``: run eagerly on the seat's
      operands (``TorchBackend.local_verify_fn()``, or a stub kernel);
    * ``seat_program(seat, B) -> program``: the backend's keyed program for
      the seat's batch of ``B`` columns (``TorchBackend.seat_program``, a
      CUDA graph on the card), called with the seat's operands.

    The seats' verdicts are gathered onto the lead seat as the ``(width,)``
    verdict vector, the one thing the host waits for.  A False at index i
    condemns only shard i's column range (``shard_bounds``), which lets the
    pod re-verify a failing shard's sets instead of the whole batch.

    ``pk_wrap(x, y) -> pk_operand`` (``TorchBackend.registry_pk_wrap``) is
    needed in registry mode only: it wraps the gathered limb planes for the
    kernel without this module importing the field code.

    The stages (``pad_operands``, ``shard_operands``, ``execute``,
    ``resolve``) are separate so that a caller can time placement against
    compute and gather, and so that ``stream_epoch`` can keep chunks in
    flight: every stage but ``resolve`` only enqueues.
    """

    def __init__(self, mesh, local_verify_fn: Callable | None = None, *, axis: str = AXIS,
                 pk_wrap: Callable | None = None, rules=PARTITION_RULES,
                 seat_program: Callable | None = None):
        if (local_verify_fn is None) == (seat_program is None):
            raise ValueError("ShardedVerifyProgram takes a local_verify_fn or a seat_program")
        self.mesh = mesh
        self.axis = axis
        self.local_verify_fn = local_verify_fn
        self.seat_program = seat_program
        self.pk_wrap = pk_wrap
        self.rules = rules
        self.width = mesh_width(mesh)
        self._programs: dict = {}

    # -- stages -------------------------------------------------------------

    def pad_operands(self, args):
        """Pad the trailing batch axis up to a width multiple with
        duplicates of column 0 (AND-safe per the marshal contract)."""
        return _pad_tail(args, (-_trailing_extent(args)) % self.width)

    def shard_operands(self, args, *, deferred_pk: bool = False) -> list:
        """Rule-place the marshalled operand tree on the mesh (no host sync):
        one operand tree per seat.  In registry mode the registry is placed
        already and the slots go whole to every seat, so only the rest of
        the program's specs apply."""
        specs = program_in_specs(
            args, deferred_pk=deferred_pk, rules=self.rules, axis=self.axis)
        specs = specs[3:] if deferred_pk else specs
        shard_fns, _ = make_shard_and_gather_fns(specs, self.mesh)
        placed = tree_apply(shard_fns, args)
        return [seat_tree(placed, i) for i in range(self.width)]

    def execute(self, seat_args: list):
        """Enqueue every seat's verify (no host sync); ``seat_args`` are the
        placed, padded operand trees.  Returns the in-flight (width,)
        verdict vector on the lead seat."""
        return self._program(seat_args[0], deferred_pk=False)(seat_args)

    def execute_registry(self, registry, slots, rest_args: list):
        """Registry mode: ``registry`` is the sharded (x, y) registry (each a
        ``Shards`` of the seats' validator-axis pieces), ``slots`` each
        seat's copy of the (B,) slot vector, ``rest_args`` the seats'
        operand trees without the pubkey operand."""
        if self.pk_wrap is None:
            raise ValueError("registry mode needs pk_wrap")
        reg_x, reg_y = registry
        x, y = _registry_gather(reg_x, reg_y, slots, self.mesh)
        seat_args = [(self.pk_wrap(x[i], y[i]),) + tuple(rest_args[i])
                     for i in range(self.width)]
        return self._program(rest_args[0], deferred_pk=True)(seat_args)

    @staticmethod
    def resolve(handle) -> np.ndarray:
        """Wait for an in-flight verdict vector -> (width,) host bools."""
        return handle.cpu().numpy().astype(bool)

    # -- one-shot conveniences ---------------------------------------------

    def dispatch(self, args):
        """pad -> shard -> execute (no host sync), one call."""
        return self.execute(self.shard_operands(self.pad_operands(tuple(args))))

    def dispatch_registry(self, registry, slots, rest_args):
        """pad -> shard -> execute_registry (no host sync), one call; the
        slots pad with duplicates of slot 0, as the operand columns do."""
        slots = _pad_slots(slots, (-int(np.shape(slots)[0])) % self.width)
        rest = self.pad_operands(tuple(rest_args))
        slots, rest = self._shard_registry_inputs(slots, rest)
        return self.execute_registry(registry, slots, rest)

    def verdict_vector(self, args) -> np.ndarray:
        return self.resolve(self.dispatch(args))

    def verdict_vector_registry(self, registry, slots, rest_args) -> np.ndarray:
        return self.resolve(self.dispatch_registry(registry, slots, rest_args))

    def _shard_registry_inputs(self, slots, rest):
        """Every seat takes the whole slot vector (the reference all-gathers
        its batch-sharded slots inside the program), and its operand
        columns."""
        slots = torch.as_tensor(slots).to(torch.int64)
        per_seat = []
        for seat in self.mesh.seats:
            with _mesh.seat_context(seat):
                per_seat.append(to_seat(slots, seat))
        return per_seat, self.shard_operands(rest, deferred_pk=True)

    def shard_bounds(self, total: int) -> tuple:
        """Per-shard [a, b) column ranges over a batch of ``total`` columns
        (before padding): shard i's verdict covers exactly the sets whose
        padded column index falls in its range."""
        padded = total + ((-total) % self.width)
        size = padded // self.width
        return tuple(
            (min(i * size, total), min((i + 1) * size, total))
            for i in range(self.width)
        )

    # -- program construction ----------------------------------------------

    def _program(self, seat0_args, *, deferred_pk: bool):
        names = tuple(n for n, _ in named_operand_leaves(seat0_args, deferred_pk=deferred_pk))
        key = (deferred_pk, names)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._build(deferred_pk)
            self._programs[key] = prog
        return prog

    def _build(self, deferred_pk: bool):
        """The staged program for one operand structure: every seat's body
        under its ``seat_context``, then the gather of the seats' verdicts
        onto the lead seat."""
        seats = self.mesh.seats
        local = None if self.local_verify_fn is None else staged_local(self.local_verify_fn)

        def seat_fn(i, args):
            if local is None:
                return self.seat_program(seats[i], _trailing_extent(args))(*args)
            return local(*args)

        def run(seat_args):
            oks = []
            for i, args in enumerate(seat_args):
                with _mesh.seat_context(seats[i]):
                    oks.append(torch.as_tensor(seat_fn(i, args)).reshape(1))
            return _mesh.allgather_tree(oks, self.mesh.lead)

        return run


def program_in_specs(semantic_args, *, deferred_pk: bool,
                     rules=PARTITION_RULES, axis: str = AXIS):
    """The placement of every operand of a staged verify: the rule-matched
    specs of the marshalled operands, prefixed in registry mode by the
    registry planes' and the slot vector's (the reference's in_specs)."""
    rest_specs = operand_partition_specs(
        semantic_args, deferred_pk=deferred_pk, rules=rules, axis=axis)
    if deferred_pk:
        return (SPEC_TOKENS["registry"](2, axis),
                SPEC_TOKENS["registry"](2, axis),
                SPEC_TOKENS["batch"](1, axis)) + rest_specs
    return rest_specs


def staged_local(fn):
    """A seat's body on the eager road: the local kernel on the seat's
    operands, its verdict as a one-element bool tensor.  In registry mode
    the seat's pubkey operand is wrapped from its gathered planes before the
    body runs: the gather spans the seats (``_registry_gather``), so it is
    a step of its own, where the reference's body starts with it."""

    def local(*a):
        with torch.inference_mode():
            return torch.as_tensor(fn(*a)).reshape(1)

    return local


def _registry_gather_local(reg_x, reg_y, slots_all, index: int, n_local: int):
    """One seat's piece of the partitioned-registry gather: the (26, B)
    columns of the slots this seat's validator shard holds (rows
    ``[index * n_local, (index + 1) * n_local)``), zero elsewhere."""
    rel = slots_all.to(torch.int64) - index * n_local
    hit = (rel >= 0) & (rel < n_local)
    safe = torch.where(hit, rel, torch.zeros_like(rel))
    mask = hit.to(reg_x.dtype)
    return reg_x.index_select(1, safe) * mask, reg_y.index_select(1, safe) * mask


def _registry_gather(reg_x, reg_y, slots, mesh):
    """The partitioned-registry gather over every seat: each seat's masked
    take, and each seat's own batch columns of every take summed onto it
    (the reference's ``psum``, of which each seat keeps only its columns).
    Returns the seats' (x, y) planes, ``(26, B / width)`` each."""
    width = mesh_width(mesh)
    seats = mesh.seats
    n_local = int(reg_x[0].shape[1])
    parts = []
    for i in range(width):
        with _mesh.seat_context(seats[i]):
            parts.append(_registry_gather_local(reg_x[i], reg_y[i], slots[i], i, n_local))
    B = int(slots[0].shape[0])
    b_local = B // width
    xs, ys = [], []
    for i in range(width):
        cols = slice(i * b_local, (i + 1) * b_local)
        with _mesh.seat_context(seats[i]):
            xs.append(sum(to_seat(p[0][:, cols], seats[i]) for p in parts).contiguous())
            ys.append(sum(to_seat(p[1][:, cols], seats[i]) for p in parts).contiguous())
    return xs, ys


# ---------------------------------------------------------------------------
# Epoch streaming: chunks in flight through the program
# ---------------------------------------------------------------------------


@dataclass
class EpochChunkResult:
    """Verdict for one streamed chunk: ``verdicts`` is the (width,)
    per-shard vector (None when marshal rejected the chunk), ``ok`` the
    chunk conjunction."""

    index: int
    n: int
    verdicts: Any
    ok: bool


def stream_epoch(chunks: Iterable, marshal: Callable,
                 program: ShardedVerifyProgram, *,
                 registry: Any = None, inflight: int = 2,
                 ) -> Iterator[EpochChunkResult]:
    """Stream set chunks through the sharded program, ``inflight`` at once.

    ``chunks`` yields lists of signature sets (an epoch's attestations in
    committee-sized bites); ``marshal`` maps one chunk to a
    ``MarshalledBatch``.  Chunk k + 1 is marshalled and its placement and
    verify enqueued while chunk k's verdict vector is still in flight; at
    most ``inflight`` chunks' operands are live at once, so the peak host
    footprint is O(chunk), never O(epoch).

    ``registry`` (``PubkeyLimbCache.registry_device_sharded``) turns on the
    partitioned-registry path for chunks whose marshal deferred the pubkey
    operand (``mb.slots is not None``).

    Yields :class:`EpochChunkResult` in chunk order.
    """
    inflight = max(1, int(inflight))
    pending: deque = deque()

    def finish(entry) -> EpochChunkResult:
        index, n, handle = entry
        if handle is None:
            return EpochChunkResult(index, n, None, False)
        v = program.resolve(handle)
        return EpochChunkResult(index, n, v, bool(v.all()))

    for index, chunk in enumerate(chunks):
        n = len(chunk)
        mb = marshal(chunk)
        if mb is None or getattr(mb, "invalid", False):
            pending.append((index, n, None))
        elif getattr(mb, "slots", None) is not None and registry is not None:
            pending.append((index, n, program.dispatch_registry(
                registry, mb.slots, mb.args)))
        else:
            pending.append((index, n, program.dispatch(tuple(mb.args))))
        # mb drops out of scope here: the host copy of a dispatched chunk
        # is freed as soon as its placement is enqueued
        del mb
        while len(pending) >= inflight:
            yield finish(pending.popleft())
    while pending:
        yield finish(pending.popleft())
