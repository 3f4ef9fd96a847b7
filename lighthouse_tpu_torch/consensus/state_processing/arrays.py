"""Dense validator-registry columns: the epoch pipeline's working set.

The port's copy of what the epoch balance pipeline needs from the JAX
package's ``consensus/state_processing/arrays.py``: the registry as parallel
numpy columns, the activity and eligibility views over them, and the
Altair participation-flag constants.  It has no ``extract`` or
``writeback``, which read the JAX package's containers: a caller builds it
from numpy columns.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FAR_FUTURE_EPOCH = 2**64 - 1
# stored as an int64 sentinel (no epoch value comes close in practice)
FAR = np.int64(2**63 - 1)


@dataclass
class ValidatorArrays:
    effective_balance: np.ndarray  # int64 gwei
    slashed: np.ndarray  # bool
    activation_eligibility_epoch: np.ndarray  # int64 (FAR sentinel)
    activation_epoch: np.ndarray
    exit_epoch: np.ndarray
    withdrawable_epoch: np.ndarray
    balances: np.ndarray  # int64 gwei

    def is_active(self, epoch: int) -> np.ndarray:
        return (self.activation_epoch <= epoch) & (epoch < self.exit_epoch)

    def is_eligible(self, previous_epoch: int) -> np.ndarray:
        """Eligible for rewards and penalties (altair
        get_eligible_validator_indices): active in the previous epoch, or
        slashed and not yet withdrawable."""
        return self.is_active(previous_epoch) | (
            self.slashed & (previous_epoch + 1 < self.withdrawable_epoch))

    def total_active_balance(self, epoch: int, increment: int) -> int:
        tb = int(self.effective_balance[self.is_active(epoch)].sum())
        return max(tb, increment)


# Altair participation flag indices and weights (spec constants)
TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2
PARTICIPATION_FLAG_WEIGHTS = (14, 26, 14)  # source, target, head
WEIGHT_DENOMINATOR = 64
PROPOSER_WEIGHT = 8
SYNC_REWARD_WEIGHT = 2
