"""Multi-seat batch verification: data-parallel sharding over a mesh.

Port of jax_backend/multichip.py.  The reference client scales batch BLS
verification across CPU cores with rayon chunks
(block_signature_verifier.rs:396-405: sets/threads chunks, AND-reduce).
Here the signature-set batch is split across the seats of a mesh
(parallel/mesh.py): each seat runs the subgroup checks, the weight scalar
muls, the signature sum and the Miller loops of its columns; the small
partials (one Fp12 and one G2 point per seat) are gathered onto the lead
seat, which runs the one final exponentiation.  The GT product is
associative, which is what lets the mesh reduce it.

The reference jits each of the two programs below into one ``shard_map``
executable.  Here every stage runs eagerly on its seat, under the seat's
``seat_context``: the users of these programs are the scaling tool and the
dry run, not the service, whose sharded path is
``parallel/partition.py``'s program over the backend's keyed graphs.
"""

from __future__ import annotations

import torch

from ....parallel import mesh as _mesh
from ....parallel.mesh import Mesh, allgather_tree, and_reduce, dp_shard_map, map_tree
from ....parallel.mesh import ring_reduce, tree_leaves
from . import fp as F
from . import pairing as PR
from . import points as P
from . import tower as T
from .backend import _neg_gen_const, _tree_reduce_g2


def _trailing_extent(tree) -> int:
    """Trailing-axis extent of the first leaf: the global batch size."""
    return int(tree_leaves(tree)[0].shape[-1])


def _pad_tail_cols(tree, pad: int):
    """Append ``pad`` copies of column 0 to every leaf's trailing axis.

    Column 0 is a real entry, so the padding is well-formed field data;
    whether it leaves the verdict alone depends on the combine: an AND of
    verdicts takes it as it is (a duplicate of a valid set stays valid, of
    an invalid one the verdict was already False), a product of Miller
    values must mask the padded lanes out (see
    ``make_pair_sharded_aggregate_verify``)."""
    if pad <= 0:
        return tree
    return map_tree(lambda a: torch.cat([a, a[..., :1].expand(*a.shape[:-1], pad)], dim=-1),
                    tree)


def make_verify_sharded(mesh: Mesh, axis: str = "batch"):
    """A mesh-sharded batch verify.

    Returns fn(pk_aff, sig_aff, h_aff, wbits) -> one-element bool tensor on
    the lead seat (in flight); every input carries the global batch on its
    trailing axis.  A batch that does not divide by the width is padded with
    duplicates of set 0 (AND-safe: padding cannot flip the conjunction)."""

    def local_part(pk_aff, sig_aff, h_aff, wbits):
        # per-seat work on its columns
        with torch.inference_mode():
            ok_sub = torch.all(P.g2_subgroup_check(sig_aff))
            wpk = P.scalar_mul_bits(P.FP_OPS, P.from_affine(P.FP_OPS, pk_aff), wbits)
            wsig = P.scalar_mul_bits(P.FP2_OPS, P.from_affine(P.FP2_OPS, sig_aff), wbits)
            S_local = _tree_reduce_g2(wsig)  # batch-1 G2 Jacobian
            wpk_aff = P.to_affine(P.FP_OPS, wpk, F.fp_inv)
            g_local = PR.gt_product(PR.miller_loop(wpk_aff, h_aff))  # batch-1 Fp12
        return g_local, S_local, ok_sub

    def epilogue(partials):
        # the small combine onto the lead seat, then fold in (-G1, S) and
        # final-exponentiate there
        lead = mesh.lead
        g_all = allgather_tree([p[0] for p in partials], lead)
        S_all = allgather_tree([p[1] for p in partials], lead)
        ok_all = and_reduce([p[2] for p in partials], lead)
        with _mesh.seat_context(lead), torch.inference_mode():
            g = PR.gt_product(g_all)
            S = _tree_reduce_g2(S_all)
            S_aff = P.to_affine(P.FP2_OPS, S, T.fp2_inv)
            f_last = PR.miller_loop(_neg_gen_const(lead), S_aff)
            # an infinite S contributes e(-G1, O) = 1
            f_last = T.fp12_select(S[3].reshape(1), PR.fp12_one_like_from_fp2(S_aff[0]),
                                   f_last)
            return PR.final_exp_is_one(T.fp12_mul(g, f_last)) & ok_all

    sharded = dp_shard_map(local_part, mesh, epilogue, axis=axis)
    n = mesh.width

    def verify(pk_aff, sig_aff, h_aff, wbits):
        pad = (-_trailing_extent(pk_aff)) % n
        if pad:
            pk_aff, sig_aff, h_aff, wbits = _pad_tail_cols((pk_aff, sig_aff, h_aff, wbits), pad)
        return sharded(pk_aff, sig_aff, h_aff, wbits)

    return verify


def make_pair_sharded_aggregate_verify(mesh: Mesh, axis: str = "batch"):
    """Shard the pairs of one aggregate verify across the mesh (the SURVEY
    section 2.8 / 5 "sequence scaling" axis).  One aggregate verify
    (blst.rs:244-255: distinct messages, one signature) whose (pk_i, H_i)
    pairs spread over the seats; each seat Miller-loops its pairs and
    multiplies its GT partial, the partials combine with an Fp12 ring
    reduction (``ring_reduce``: the ring-attention accumulation), and the
    final exponentiation runs on the lead seat.

    Returns fn(pk_aff, h_aff, sig_aff) -> one-element bool tensor on the
    lead seat: pk and h carry the pairs on the trailing axis, sig is the
    batch-1 aggregate signature.  A pair count that does not divide by the
    width is padded with duplicates of pair 0 and a pad mask: a padded
    pair's Miller value would multiply into the one GT product, so padded
    lanes are set to Fp12 one before the local product."""

    def local_part(pk_aff, h_aff, sig_aff, pad_mask):
        with torch.inference_mode():
            ok_sub = torch.all(P.g2_subgroup_check(sig_aff))
            f_local = PR.miller_loop(pk_aff, h_aff)
            one = PR.fp12_one_like_from_fp2(f_local[0][0])
            f_local = T.fp12_select(pad_mask, one, f_local)
            return PR.gt_product(f_local), ok_sub  # one Fp12 partial per seat

    def epilogue(partials, sig_lead):
        lead = mesh.lead
        # the ring: N - 1 hops, each seat folding its neighbour's partial
        ring = ring_reduce([p[0] for p in partials], _fp12_mul_inference, mesh.seats)
        ok_all = and_reduce([p[1] for p in partials], lead)
        with _mesh.seat_context(lead), torch.inference_mode():
            f_last = PR.miller_loop(_neg_gen_const(lead), sig_lead)
            total = T.fp12_mul(PR.gt_product(ring[0]), f_last)
            return PR.final_exp_is_one(total) & ok_all

    n = mesh.width

    def aggregate_verify(pk_aff, h_aff, sig_aff):
        pairs = _trailing_extent(pk_aff)
        pad = (-pairs) % n
        if pad:
            pk_aff, h_aff = _pad_tail_cols((pk_aff, h_aff), pad)
        pad_mask = torch.arange(pairs + pad, device=tree_leaves(pk_aff)[0].device) >= pairs
        # the signature is replicated: every seat takes a copy, not a shard
        sigs = [map_tree(lambda t, s=seat: _mesh.to_seat(t, s), sig_aff) for seat in mesh.seats]
        shards = _mesh.shard_tree((pk_aff, h_aff, pad_mask), mesh)
        partials = []
        for seat, shard, sig in zip(mesh.seats, shards, sigs):
            with _mesh.seat_context(seat):
                partials.append(local_part(shard[0], shard[1], sig, shard[2]))
        return epilogue(partials, sigs[0])

    return aggregate_verify


def _fp12_mul_inference(a, b):
    with torch.inference_mode():
        return T.fp12_mul(a, b)
