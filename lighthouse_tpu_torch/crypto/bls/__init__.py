"""BLS12-381 signatures: host containers (api.py) and the batched
PyTorch verification backend (torch_backend/)."""

from .api import (  # noqa: F401
    AggregatePublicKey,
    AggregateSignature,
    BlsError,
    PublicKey,
    SecretKey,
    Signature,
    SignatureSet,
    cpu_backend,
    get_backend,
    register_backend,
    set_backend,
    verify_signature_sets,
)
from . import params  # noqa: F401
