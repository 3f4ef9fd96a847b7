"""EIP-3076 slashing protection: the database consulted before EVERY sign.

Twin of validator_client/slashing_protection (SQLite `SlashingDatabase`,
src/slashing_database.rs; EIP-3076 interchange import/export).  Same
storage engine choice as the reference (SQLite — stdlib sqlite3 here), same
minimal-pruning semantics: refuse any block proposal at or below the
highest signed slot for the key unless identical, refuse any attestation
that double-votes or surrounds/is surrounded.

Crash-safety: the connection runs in autocommit with explicit
``BEGIN IMMEDIATE`` transactions around every check-and-insert, WAL
journaling, and ``synchronous=FULL`` so a committed record survives a
``kill -9`` the instant `check_and_insert_*` returns.  The insert-before-
sign discipline (the reference's interchange spec requirement) means a
crash can at worst record a message that was never broadcast — never the
reverse.
"""

from __future__ import annotations

import json
import sqlite3
from contextlib import contextmanager


class SlashingProtectionError(Exception):
    """Signing REFUSED: would violate slashing conditions."""


class NotRegistered(SlashingProtectionError):
    pass


class SlashingDatabase:
    def __init__(self, path: str = ":memory:", genesis_validators_root: bytes = b""):
        # cross-thread access (keymanager HTTP handlers + VC services share
        # one DB — the reference pools its SQLite connections the same
        # way); sqlite's serialized mode + the GIL make this safe for the
        # short statement bursts used here
        # isolation_level=None: true autocommit — transaction boundaries
        # are OURS (BEGIN IMMEDIATE in _txn), not the driver's implicit
        # deferred transactions, so nothing lingers unflushed
        self.conn = sqlite3.connect(
            path, check_same_thread=False, isolation_level=None
        )
        self.conn.execute("PRAGMA journal_mode=WAL")
        # FULL: fsync the WAL on every commit — a power cut after
        # check_and_insert_* returns cannot lose the record (NORMAL, the
        # WAL default, may lose the last commits on an OS crash)
        self.conn.execute("PRAGMA synchronous=FULL")
        self.conn.executescript(
            """
            CREATE TABLE IF NOT EXISTS validators (
                id INTEGER PRIMARY KEY, pubkey BLOB UNIQUE NOT NULL);
            CREATE TABLE IF NOT EXISTS signed_blocks (
                validator_id INTEGER NOT NULL REFERENCES validators(id),
                slot INTEGER NOT NULL, signing_root BLOB,
                UNIQUE (validator_id, slot));
            CREATE TABLE IF NOT EXISTS signed_attestations (
                validator_id INTEGER NOT NULL REFERENCES validators(id),
                source_epoch INTEGER NOT NULL, target_epoch INTEGER NOT NULL,
                signing_root BLOB, UNIQUE (validator_id, target_epoch));
            CREATE TABLE IF NOT EXISTS metadata (
                key TEXT PRIMARY KEY, value BLOB);
            """
        )
        if genesis_validators_root:
            self.conn.execute(
                "INSERT OR REPLACE INTO metadata VALUES ('gvr', ?)",
                (genesis_validators_root,),
            )

    @contextmanager
    def _txn(self):
        """One atomic check-and-insert.  BEGIN IMMEDIATE takes the write
        lock up front so the check and the insert see the same state even
        with concurrent keymanager threads; COMMIT is the durability point
        (fsync'd under synchronous=FULL)."""
        self.conn.execute("BEGIN IMMEDIATE")
        try:
            yield self.conn
        except BaseException:
            self.conn.execute("ROLLBACK")
            raise
        else:
            self.conn.execute("COMMIT")

    # ------------------------------------------------------------ registry

    def register_validator(self, pubkey: bytes) -> int:
        with self._txn():
            self.conn.execute(
                "INSERT OR IGNORE INTO validators (pubkey) VALUES (?)", (pubkey,)
            )
        return self._vid(pubkey)

    def _vid(self, pubkey: bytes) -> int:
        row = self.conn.execute(
            "SELECT id FROM validators WHERE pubkey = ?", (pubkey,)
        ).fetchone()
        if row is None:
            raise NotRegistered(f"pubkey {pubkey.hex()[:16]} not registered")
        return row[0]

    # -------------------------------------------------------------- blocks

    def check_and_insert_block_proposal(
        self, pubkey: bytes, slot: int, signing_root: bytes
    ) -> None:
        """Record a proposal or raise.  Same-slot identical signing root is
        permitted (re-broadcast); anything else at a signed slot is a
        double proposal; slots below the maximum signed slot are refused
        (minimal-pruning lower bound).

        Check and insert share one BEGIN IMMEDIATE transaction: the record
        is fsync'd before this returns, and the caller signs only after it
        returns (insert-before-sign)."""
        vid = self._vid(pubkey)
        with self._txn():
            row = self.conn.execute(
                "SELECT signing_root FROM signed_blocks WHERE validator_id=? AND slot=?",
                (vid, slot),
            ).fetchone()
            if row is not None:
                if row[0] == signing_root:
                    return  # identical re-sign ok
                raise SlashingProtectionError(f"double block proposal at slot {slot}")
            maxrow = self.conn.execute(
                "SELECT MAX(slot) FROM signed_blocks WHERE validator_id=?", (vid,)
            ).fetchone()
            if maxrow[0] is not None and slot < maxrow[0]:
                raise SlashingProtectionError(
                    f"slot {slot} at/below minimum signed slot {maxrow[0]}"
                )
            self._record_block(vid, slot, signing_root)

    def _record_block(self, vid: int, slot: int, signing_root: bytes) -> None:
        """The actual insert, split out so crash tests can fault it (a
        crash here must leave NO record — the surrounding transaction
        rolls back)."""
        self.conn.execute(
            "INSERT INTO signed_blocks VALUES (?,?,?)", (vid, slot, signing_root)
        )

    # -------------------------------------------------------- attestations

    def check_and_insert_attestation(
        self, pubkey: bytes, source_epoch: int, target_epoch: int,
        signing_root: bytes,
    ) -> None:
        """EIP-3076 attestation rules: no double vote (same target unless
        identical root), no surrounding, no surrounded, monotonic lower
        bounds."""
        if source_epoch > target_epoch:
            raise SlashingProtectionError("source after target")
        vid = self._vid(pubkey)
        with self._txn():
            row = self.conn.execute(
                "SELECT signing_root FROM signed_attestations "
                "WHERE validator_id=? AND target_epoch=?",
                (vid, target_epoch),
            ).fetchone()
            if row is not None:
                if row[0] == signing_root:
                    return
                raise SlashingProtectionError(
                    f"double vote at target epoch {target_epoch}"
                )
            # surround checks against everything recorded
            surround = self.conn.execute(
                "SELECT 1 FROM signed_attestations WHERE validator_id=? AND "
                "((source_epoch < ? AND ? < target_epoch) OR "  # we surround prior
                " (? < source_epoch AND target_epoch < ?))",  # prior surrounds us
                (vid, source_epoch, target_epoch, source_epoch, target_epoch),
            ).fetchone()
            if surround is not None:
                raise SlashingProtectionError("surround vote")
            bounds = self.conn.execute(
                "SELECT MAX(source_epoch), MAX(target_epoch) FROM "
                "signed_attestations WHERE validator_id=?",
                (vid,),
            ).fetchone()
            if bounds[0] is not None and source_epoch < bounds[0]:
                raise SlashingProtectionError("source below minimum signed source")
            if bounds[1] is not None and target_epoch <= bounds[1]:
                raise SlashingProtectionError("target at/below minimum signed target")
            self._record_attestation(vid, source_epoch, target_epoch, signing_root)

    def _record_attestation(
        self, vid: int, source_epoch: int, target_epoch: int, signing_root: bytes
    ) -> None:
        self.conn.execute(
            "INSERT INTO signed_attestations VALUES (?,?,?,?)",
            (vid, source_epoch, target_epoch, signing_root),
        )

    # --------------------------------------------------------- interchange

    def export_interchange(self, genesis_validators_root: bytes) -> dict:
        """EIP-3076 interchange JSON (complete format)."""
        data = []
        for vid, pubkey in self.conn.execute("SELECT id, pubkey FROM validators"):
            blocks = [
                {"slot": str(s), "signing_root": "0x" + (r or b"").hex()}
                for s, r in self.conn.execute(
                    "SELECT slot, signing_root FROM signed_blocks "
                    "WHERE validator_id=?",
                    (vid,),
                )
            ]
            atts = [
                {
                    "source_epoch": str(se),
                    "target_epoch": str(te),
                    "signing_root": "0x" + (r or b"").hex(),
                }
                for se, te, r in self.conn.execute(
                    "SELECT source_epoch, target_epoch, signing_root FROM "
                    "signed_attestations WHERE validator_id=?",
                    (vid,),
                )
            ]
            data.append(
                {
                    "pubkey": "0x" + pubkey.hex(),
                    "signed_blocks": blocks,
                    "signed_attestations": atts,
                }
            )
        return {
            "metadata": {
                "interchange_format_version": "5",
                "genesis_validators_root": "0x" + genesis_validators_root.hex(),
            },
            "data": data,
        }

    def import_interchange(self, interchange: dict | str) -> None:
        ic = json.loads(interchange) if isinstance(interchange, str) else interchange
        if ic["metadata"]["interchange_format_version"] != "5":
            raise SlashingProtectionError("unsupported interchange version")
        # one transaction for the whole interchange: an import interrupted
        # mid-way leaves the database exactly as it was, never half a file
        with self._txn():
            for entry in ic["data"]:
                pubkey = bytes.fromhex(entry["pubkey"][2:])
                self.conn.execute(
                    "INSERT OR IGNORE INTO validators (pubkey) VALUES (?)",
                    (pubkey,),
                )
                vid = self._vid(pubkey)
                for b in entry.get("signed_blocks", []):
                    self.conn.execute(
                        "INSERT OR IGNORE INTO signed_blocks VALUES (?,?,?)",
                        (
                            vid,
                            int(b["slot"]),
                            bytes.fromhex(b.get("signing_root", "0x")[2:]),
                        ),
                    )
                for a in entry.get("signed_attestations", []):
                    self.conn.execute(
                        "INSERT OR IGNORE INTO signed_attestations VALUES (?,?,?,?)",
                        (
                            vid,
                            int(a["source_epoch"]),
                            int(a["target_epoch"]),
                            bytes.fromhex(a.get("signing_root", "0x")[2:]),
                        ),
                    )

    def close(self):
        self.conn.close()
