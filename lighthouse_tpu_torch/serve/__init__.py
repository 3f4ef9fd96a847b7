"""lighthouse_tpu_torch.serve — the multi-tenant verification front door.

The port's copy of the JAX package's ``serve/`` over ``TorchBackend``: many
validator clients and light nodes submit signature-set batches over a Beacon-API-shaped HTTP
edge; a deadline-aware batcher coalesces them into device batches; a
per-tenant admission controller (token buckets, bounded queue depth,
priority classes, degraded-mode shedding) keeps one greedy tenant from
collapsing everyone else.  The verifier underneath is the same
``IngestEngine`` -> ``ResilientVerifier`` -> ``PodVerifier`` ->
``IntegrityGuard`` ladder, built by the one construction path in
:mod:`~lighthouse_tpu_torch.serve.stack`.  ``python -m
lighthouse_tpu_torch.serve`` runs it standalone on the card.
"""

from .admission import AdmissionController, PRIORITY_CLASSES, TenantPolicy
from .batcher import DeadlineAwareBatcher
from .http import ServeApiServer, decode_sets, last_server
from .service import ServeRequest, SubmitResult, VerifyService
from .stack import VerifyStack, build_verify_stack

__all__ = [
    "AdmissionController",
    "DeadlineAwareBatcher",
    "PRIORITY_CLASSES",
    "ServeApiServer",
    "ServeRequest",
    "SubmitResult",
    "TenantPolicy",
    "VerifyService",
    "VerifyStack",
    "build_verify_stack",
    "decode_sets",
    "last_server",
]
