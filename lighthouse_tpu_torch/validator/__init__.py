"""Validator client layer — twin of validator_client/ (+ slashing
protection)."""

from .client import (  # noqa: F401
    AttestationService,
    BlockService,
    DoppelgangerService,
    DutiesService,
    Duty,
    ValidatorStore,
)
from .slashing_protection import (  # noqa: F401
    SlashingDatabase,
    SlashingProtectionError,
)
