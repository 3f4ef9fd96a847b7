"""Batch ingest engine: the array-at-a-time counterpart of the scalar marshal.

Port of the JAX package's ``ingest/engine.py`` over the port's
``TorchBackend``.  ``TorchBackend.marshal_sets`` walks the batch one set at
a time (per-set hashing, pubkey aggregation, limb encode) and runs in
series with the card.  ``IngestEngine.marshal_sets`` produces a
byte-identical ``MarshalledBatch`` from three vectorized stages:

1. *expand*: every message's hash-to-field draw runs through the batched
   SHA-256 lanes (``sha``), each distinct message once, sharded across host
   cores by the ``MarshalPool``;
2. *cache*: aggregated-pubkey limb columns come from the
   ``PubkeyLimbCache``; repeat signers (registry validators, warm
   committees) skip host aggregation and limb encode, and a batch whose sets
   are all single registry signers gathers its pubkey operand on the card
   (``index_select`` on the resident registry), wrapped by
   ``TorchBackend.registry_pk_wrap``;
3. *encode*: the other operands (signatures, u-draws or H(m) points,
   weights) are built by the codecs the scalar path uses, padded and packed
   by the same rules, as CPU tensors of its dtypes, shapes and bounds.

The scalar path stays the differential oracle and the degraded mode:
``marshal_sets`` never raises.  A failure of the vectorized path falls back
to ``backend.marshal_sets``, and a failure there yields an invalid batch.
Both marshals take an optional ``weights`` list, so the tests can pin the
random weight draw and compare every operand byte for byte.

Streams: the gather is enqueued on the marshalling thread's current stream
and an event recorded after it rides in the batch (``MarshalledBatch.ready``);
``TorchBackend.dispatch`` makes its own stream wait for that event, so a
marshal on a worker thread and a dispatch on another stream stay ordered.
"""

from __future__ import annotations

import logging
import secrets
import time

import numpy as np
import torch

from ..crypto.bls import params
from ..crypto.bls.torch_backend import fp as F
from ..crypto.bls.torch_backend import points as P
from ..crypto.bls.torch_backend import tower as T
from ..crypto.bls.torch_backend.backend import MarshalledBatch, _pack_wbits
from ..obs.tracer import TRACER
from ..utils import faults as _faults
from ..utils import metrics as M
from .cache import PubkeyLimbCache
from .pool import MarshalPool
from .sha import hash_to_field_fp2_batch

log = logging.getLogger("lighthouse_tpu_torch.ingest.engine")

_HOST = torch.device("cpu")


class IngestEngine:
    """Vectorized marshal front-end over a ``TorchBackend``.

    backend:        the ``TorchBackend`` whose scalar ``marshal_sets`` is both
                    the fallback and the byte-identity oracle.
    pubkey_cache:   optional registry (``len`` and ``get(i)``, as the beacon
                    ``ValidatorPubkeyCache``); the cache's registry tier is
                    synced from it before each marshal (a length check when
                    nothing is new).
    device_gather:  gather the pubkey operand of an all-registry batch on the
                    device.  ``None`` (the default) turns it on when the
                    backend's device is a CUDA card.
    """

    def __init__(self, backend, pubkey_cache=None, cache=None, pool=None,
                 device_gather: bool | None = None, lru_capacity: int | None = None):
        self._backend = backend
        self._pubkey_cache = pubkey_cache
        if cache is None:
            kw = {} if lru_capacity is None else {"lru_capacity": lru_capacity}
            cache = PubkeyLimbCache(device=backend.device, **kw)
        self.cache = cache
        self.pool = pool if pool is not None else MarshalPool()
        self._device_gather = device_gather

    # -- lifecycle ---------------------------------------------------------

    def begin_epoch(self, epoch: int) -> None:
        """Epoch-boundary hook: invalidate the aggregate cache tier."""
        self.cache.begin_epoch(epoch)

    def close(self) -> None:
        self.pool.close()

    def _use_device_gather(self) -> bool:
        if self._device_gather is None:
            self._device_gather = self._backend.device.type == "cuda"
        return self._device_gather

    # -- the never-raise marshal entry points ------------------------------
    # The ladder: vectorized -> scalar marshal -> invalid batch.

    def marshal_sets(self, sets, weights=None) -> MarshalledBatch:
        """Marshal ``sets`` vectorized; byte-identical to the scalar
        ``backend.marshal_sets`` on every input.  Never raises."""
        try:
            _faults.fire("ingest.marshal")
            return self._marshal_vectorized(sets, weights)
        except Exception:
            M.INGEST_FALLBACKS.inc()
            log.warning("ingest: vectorized marshal failed; degrading to the scalar path",
                        exc_info=True)
        try:
            return self._backend.marshal_sets(sets, weights)
        except Exception:
            M.INGEST_FALLBACKS.inc()
            log.error("ingest: scalar fallback failed; marking the batch invalid",
                      exc_info=True)
        return MarshalledBatch(len(sets), 0, self._backend.device_h2c, invalid=True)

    def marshal_for_mesh(self, sets, weights=None) -> MarshalledBatch:
        """Marshal for a sharded program: when every set resolves to a
        single-signer registry slot, the pubkey operand is deferred, the
        batch carries the (B,) int32 slot vector (``mb.slots``) and its
        ``args`` leave the pubkeys out; only a mesh path may take such a
        batch (``TorchBackend.dispatch`` refuses it).  Any other batch is
        marshalled as by ``marshal_sets``.  Never raises."""
        try:
            _faults.fire("ingest.marshal")
            return self._marshal_vectorized(sets, weights, defer_registry=True)
        except Exception:
            M.INGEST_FALLBACKS.inc()
            log.warning("ingest: mesh marshal failed; degrading to the standard path",
                        exc_info=True)
        return self.marshal_sets(sets, weights)

    # -- vectorized pipeline ----------------------------------------------

    def _marshal_vectorized(self, sets, weights=None,
                            defer_registry: bool = False) -> MarshalledBatch:
        backend = self._backend
        if not sets:
            return MarshalledBatch(0, 0, backend.device_h2c, invalid=True)
        n = len(sets)
        if self._pubkey_cache is not None:
            self.cache.sync_registry(self._pubkey_cache)
        t0 = time.perf_counter()
        with TRACER.span("ingest.marshal", sets=n):
            # the scalar loop's early outs: a malformed set invalidates the batch
            for s in sets:
                if s.signature.point is None or not s.signing_keys:
                    return MarshalledBatch(n, 0, backend.device_h2c, invalid=True)

            B = backend._padded_size(n)
            reps = B - n
            with TRACER.span("ingest.encode", sets=n):
                slots = resolved = pk_operand = ready = None
                if defer_registry:
                    slots, resolved = self._registry_slots(sets, reps)
                if slots is None:
                    pk = self._pk_operand(sets, n, B, reps, resolved=resolved)
                    if pk is None:  # an aggregate was infinity
                        return MarshalledBatch(n, 0, backend.device_h2c, invalid=True)
                    pk_operand, ready = pk
                sig_pts = [s.signature.point for s in sets]
                sig_pts += [sig_pts[0]] * reps
                sig_aff = P.g2_encode(sig_pts, _HOST)
                wbits = _pack_wbits(self._weights(weights, n, reps))

            msgs = [s.message for s in sets]
            with TRACER.span("ingest.expand", sets=n):
                us = self._expand_dedup(msgs)
            if backend.device_h2c:
                us += [us[0]] * reps
                u0 = T.fp2_encode([u[0] for u in us], _HOST)
                u1 = T.fp2_encode([u[1] for u in us], _HOST)
                args = (sig_aff, u0, u1, wbits)
            else:
                # host hash-to-curve: the field draws come from the batched SHA
                # lanes, the curve steps (SSWU, isogeny, cofactor) are the
                # scalar building blocks hash_to_g2 composes
                from ..crypto.bls.curve import affine_add
                from ..crypto.bls.endo import clear_cofactor_fast
                from ..crypto.bls.fields import Fp2
                from ..crypto.bls.hash_to_curve import iso_map, sswu

                h_pts = []
                for u0_, u1_ in us:
                    h = clear_cofactor_fast(
                        affine_add(iso_map(sswu(u0_)), iso_map(sswu(u1_)), Fp2))
                    if h is None:  # probability zero; as the scalar path
                        return MarshalledBatch(n, 0, backend.device_h2c, invalid=True)
                    h_pts.append(h)
                h_pts += [h_pts[0]] * reps
                args = (sig_aff, P.g2_encode(h_pts, _HOST), wbits)
            if slots is None:
                args = (pk_operand,) + args
        elapsed = time.perf_counter() - t0
        if elapsed > 0:
            M.INGEST_MARSHAL_RATE.set(n / elapsed)
        return MarshalledBatch(n, B, backend.device_h2c, args, slots=slots, ready=ready)

    # -- stage helpers -----------------------------------------------------

    def _expand_dedup(self, msgs: list[bytes]) -> list[list]:
        """Hash-to-field draws for ``msgs``, each distinct message hashed
        once: a committee's sets share one signing root, and hashing is a
        pure function of the message, so fanning out after deduplication
        gives the scalar path's values."""
        uniq = list(dict.fromkeys(msgs))
        us_u = self.pool.map_shards(lambda ms: hash_to_field_fp2_batch(ms, 2), uniq)
        if len(uniq) == len(msgs):
            return us_u
        by_msg = dict(zip(uniq, us_u))
        return [by_msg[m] for m in msgs]

    def _registry_slots(self, sets, reps: int):
        """The deferred-pubkey path's precondition: a padded (B,) int32 slot
        tensor when every set is a single-signer registry hit, else (None,
        resolved), so that the operand path reuses the one cache resolve."""
        resolved = self.cache.resolve_batch(sets)
        slots, cols, missing = resolved
        if cols or missing or (slots < 0).any():
            return None, resolved
        if reps:
            slots = np.concatenate([slots, np.full(reps, slots[0], dtype=slots.dtype)])
        return torch.from_numpy(slots.astype(np.int32)), resolved

    def _pk_operand(self, sets, n: int, B: int, reps: int, resolved=None):
        """The padded batch's aggregated-pubkey operand, cache first, and the
        event after its device gather (None when assembled on the host).
        None when a signer set aggregates to infinity (the scalar path's
        invalid batch)."""
        from ..crypto.bls.curve import Fp, from_jacobian, jac_add, to_jacobian

        slots, cols, missing = (resolved if resolved is not None
                                else self.cache.resolve_batch(sets))
        if missing:
            agg_pts = []
            for i in missing:
                keys = sets[i].signing_keys
                if len(keys) == 1:
                    agg = keys[0].point
                else:
                    acc = to_jacobian(None, Fp)
                    for pk in keys:
                        acc = jac_add(acc, to_jacobian(pk.point, Fp), Fp)
                    agg = from_jacobian(acc, Fp)
                if agg is None:
                    return None
                agg_pts.append(agg)
            xs = F.encode_mont([p[0].v for p in agg_pts])
            ys = F.encode_mont([p[1].v for p in agg_pts])
            entries = []
            for j, i in enumerate(missing):
                xc = np.ascontiguousarray(xs[:, j])
                yc = np.ascontiguousarray(ys[:, j])
                cols[i] = (xc, yc)
                entries.append((sets[i].signing_keys, xc, yc))
            self.cache.insert_aggregates(entries)

        if not cols and self._use_device_gather():
            # every set is a registry slot: one gather on the device, no host
            # limb assembly, no host-to-device pubkey copy at dispatch
            pad = np.concatenate([slots, np.full(reps, slots[0], dtype=slots.dtype)])
            gx, gy = self.cache.gather_device(pad)
            ready = None
            if gx.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(gx.device))
            return self._backend.registry_pk_wrap(gx, gy), ready

        pk_x = np.empty((F.N, B), dtype=np.int32)
        pk_y = np.empty((F.N, B), dtype=np.int32)
        reg_idx = np.nonzero(slots >= 0)[0]
        if reg_idx.size:
            rx, ry = self.cache.registry_columns(slots[reg_idx])
            pk_x[:, reg_idx] = rx
            pk_y[:, reg_idx] = ry
        for i, (xc, yc) in cols.items():
            pk_x[:, i] = xc
            pk_y[:, i] = yc
        if reps:
            pk_x[:, n:] = pk_x[:, :1]
            pk_y[:, n:] = pk_y[:, :1]
        return (F.LFp(torch.from_numpy(pk_x), 1.0), F.LFp(torch.from_numpy(pk_y), 1.0)), None

    @staticmethod
    def _weights(weights, n: int, reps: int) -> list[int]:
        """Per-set weights, padded: given (tests) or drawn in one
        ``token_bytes`` call instead of n ``randbits`` calls."""
        if weights is not None:
            ws = [int(w) for w in weights]
            if len(ws) != n:
                raise ValueError(f"{len(ws)} weights for {n} sets")
        else:
            mask = (1 << params.RAND_BITS) - 1
            nbytes = (params.RAND_BITS + 7) // 8
            buf = secrets.token_bytes(nbytes * n)
            ws = [int.from_bytes(buf[i * nbytes:(i + 1) * nbytes], "little") & mask
                  for i in range(n)]
            for i, w in enumerate(ws):
                while w == 0:  # a zero weight would void the check
                    w = secrets.randbits(params.RAND_BITS)
                ws[i] = w
        return ws + [ws[0]] * reps
