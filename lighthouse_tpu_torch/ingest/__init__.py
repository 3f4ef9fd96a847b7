"""Vectorized ingest engine: the batch marshal in front of ``TorchBackend``.

The port of the JAX package's ``ingest`` package:

* ``sha``: batched SHA-256 / RFC 9380 expand_message_xmd lanes, one numpy
  op per hash round for the whole batch;
* ``cache``: the pubkey limb cache, a registry tier keyed by validator index
  and mirrored on the card, and an epoch-scoped aggregate LRU;
* ``pool``: a thread pool that shards the numpy stages across host cores;
* ``engine``: ``IngestEngine``, the never-raise ``marshal_sets``,
  byte-identical to the backend's scalar marshal and degrading to it on any
  failure.

Wire it in front of the backend as the marshal stage:
``PipelinedVerifier.for_backend(..., backend, ingest=engine)``, or call
``backend.dispatch(engine.marshal_sets(sets))`` and ``backend.resolve``.
"""

from .cache import PubkeyLimbCache
from .engine import IngestEngine
from .pool import MarshalPool

__all__ = ["IngestEngine", "MarshalPool", "PubkeyLimbCache"]
