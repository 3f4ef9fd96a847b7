"""Dense validator-registry arrays — the state-transition working set.

The reference walks `Vec<Validator>` per validator (consensus/
state_processing/src/per_epoch_processing/). Here the registry is extracted
ONCE per transition into parallel numpy columns; every epoch computation
becomes vectorized arithmetic over them (and is jnp-compatible for the
device path — per SURVEY §7.7 epoch processing over ~1M validators is an
embarrassingly parallel dense workload).  `writeback` applies mutated
columns to the SSZ containers at the end.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FAR_FUTURE_EPOCH = 2**64 - 1
# stored as int64 sentinel (no epoch value comes close in practice)
FAR = np.int64(2**63 - 1)


def _e(v: int) -> np.int64:
    return FAR if v >= FAR_FUTURE_EPOCH else np.int64(v)


@dataclass
class ValidatorArrays:
    effective_balance: np.ndarray  # int64 gwei
    slashed: np.ndarray  # bool
    activation_eligibility_epoch: np.ndarray  # int64 (FAR sentinel)
    activation_epoch: np.ndarray
    exit_epoch: np.ndarray
    withdrawable_epoch: np.ndarray
    balances: np.ndarray  # int64 gwei

    @classmethod
    def extract(cls, state) -> "ValidatorArrays":
        vs = state.validators
        n = len(vs)
        out = cls(
            effective_balance=np.fromiter(
                (v.effective_balance for v in vs), np.int64, n
            ),
            slashed=np.fromiter((v.slashed for v in vs), bool, n),
            activation_eligibility_epoch=np.fromiter(
                (_e(v.activation_eligibility_epoch) for v in vs), np.int64, n
            ),
            activation_epoch=np.fromiter(
                (_e(v.activation_epoch) for v in vs), np.int64, n
            ),
            exit_epoch=np.fromiter((_e(v.exit_epoch) for v in vs), np.int64, n),
            withdrawable_epoch=np.fromiter(
                (_e(v.withdrawable_epoch) for v in vs), np.int64, n
            ),
            balances=np.asarray(state.balances, dtype=np.int64).copy(),
        )
        return out

    def writeback(self, state) -> None:
        def back(x: np.int64) -> int:
            return FAR_FUTURE_EPOCH if x == FAR else int(x)

        # Compare-and-replace: re-extract the current columns (vectorized)
        # and touch only validators whose values actually changed.  Frozen
        # registry entries (cheap-node copy-on-write) are replaced via
        # thawed()+freeze() so the registry stays all-frozen and shared
        # roots/copies stay valid; mutable entries are updated in place as
        # before.
        cur = ValidatorArrays.extract(state)
        changed = (
            (cur.effective_balance != self.effective_balance)
            | (cur.slashed != self.slashed)
            | (
                cur.activation_eligibility_epoch
                != self.activation_eligibility_epoch
            )
            | (cur.activation_epoch != self.activation_epoch)
            | (cur.exit_epoch != self.exit_epoch)
            | (cur.withdrawable_epoch != self.withdrawable_epoch)
        )
        idxs = np.nonzero(changed)[0]
        if len(idxs):
            vs = list(state.validators)
            replaced = False
            for i in idxs:
                i = int(i)
                changes = {
                    "effective_balance": int(self.effective_balance[i]),
                    "slashed": bool(self.slashed[i]),
                    "activation_eligibility_epoch": back(
                        self.activation_eligibility_epoch[i]
                    ),
                    "activation_epoch": back(self.activation_epoch[i]),
                    "exit_epoch": back(self.exit_epoch[i]),
                    "withdrawable_epoch": back(self.withdrawable_epoch[i]),
                }
                v = vs[i]
                if v.__dict__.get("_frozen"):
                    vs[i] = v.thawed(**changes).freeze()
                    replaced = True
                else:
                    for k, val in changes.items():
                        setattr(v, k, val)
            if replaced:
                state.validators = vs
        state.balances = [int(b) for b in self.balances]

    # ----------------------------------------------------------------- views

    def is_active(self, epoch: int) -> np.ndarray:
        return (self.activation_epoch <= epoch) & (epoch < self.exit_epoch)

    def is_eligible(self, previous_epoch: int) -> np.ndarray:
        """Eligible for rewards/penalties (altair get_eligible_validator_
        indices): active previously, or slashed and not yet withdrawable."""
        return self.is_active(previous_epoch) | (
            self.slashed & (previous_epoch + 1 < self.withdrawable_epoch)
        )

    def total_active_balance(self, epoch: int, increment: int) -> int:
        tb = int(self.effective_balance[self.is_active(epoch)].sum())
        return max(tb, increment)


# Altair participation flag indices/weights (spec constants, used by
# per_epoch rewards and per_block attestation processing)
TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2
PARTICIPATION_FLAG_WEIGHTS = (14, 26, 14)  # source, target, head
WEIGHT_DENOMINATOR = 64
PROPOSER_WEIGHT = 8
SYNC_REWARD_WEIGHT = 2
