"""AOT program store: what a node built, kept on disk, and built again at boot.

Port of jax_backend/aot.py.  A node builds a handful of programs, one per
key, and streams batches through them; every boot pays those builds again.
The reference makes the compiled executables themselves durable.  The port
cannot: a CUDA graph is made of live device pointers and cannot be written to
disk.  What it keeps instead is what a build needs to start before the first
batch arrives:

* :class:`AotStore`, an on-disk store: one entry per program, keyed by the
  same ``program_fingerprint`` its build record carries (program name x key
  x torch and CUDA versions x device), indexed by a signed ``manifest.json``
  with the reference's layout (``entries``, ``plan``, ``plan_signature``).
  An entry's blob is the program's **operand skeleton** (the counterpart of
  the reference's ``_abstractify``): a canonical JSON of the operand tree
  giving each leaf's shape, dtype and LFp bound (or none), content-hashed
  into ``sha256`` and ``size`` as the reference hashes its StableHLO blob.
  Capture is a side effect of normal operation: a program's first build
  calls the store (``TorchBackend.attach_aot_store``), so a node that has
  served traffic has a store that describes its working set.
* :func:`prewarm`, the boot phase: install the tuned arm plan, then, for
  every entry current in this process, build its program from zeros of the
  skeleton's shapes on the backend's device (``TorchBackend.install_program``:
  warm-up, capture, instantiate), before the node takes traffic.  A
  prewarmed process builds no program on its serving path; with
  ``backend.enable_compile_cache`` on a kept build root it runs no nvcc
  either.

Integrity (never-raise): a corrupt, truncated, tampered or stale entry costs
only the time to find it out.  ``load`` returns None (the key is built from
traffic, as on a cold boot) and counts the event in
``aot_cache_rejects_total``.  The manifest is signed (sha256 over a
domain-separated canonical encoding), so partial writes and hand edits are
found as a unit; each blob is checked against its own sha256.  A build of a
current, intact entry that fails (warm-up, capture or instantiation) raises:
nothing falls back to the eager program.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import threading
import time
from dataclasses import dataclass, field

import torch

from ....obs.tracer import TRACER
from ....utils import device_kind
from ....utils.metrics import AOT_CACHE_HITS, AOT_CACHE_MISSES, AOT_CACHE_REJECTS
from . import fp as F
from . import program as PG

log = logging.getLogger("lighthouse_tpu_torch.aot")

MANIFEST_SCHEMA = 1

# Domain separator for the manifest signature: sha256 over this prefix +
# the canonical (sorted-keys, compact) JSON of the entries table.  Not a
# MAC — there is no secret; the signature detects truncation, partial
# writes and accidental edits as a unit, the same trust model as the
# per-blob content hashes.
MANIFEST_DOMAIN = "lighthouse-tpu/aot-manifest/v1:"

# The registered program set eligible for AOT capture from the serving
# path: the batch-verify kernels (both h2c modes) and the rare-path
# aggregate kernel.  Keep this a literal tuple — the ``aot-manifest``
# registry-lint family AST-parses it and cross-references (a) every name
# here against the kernel definitions in backend.py and (b) every
# manifest entry's ``kernel`` field against this set (orphans are
# findings in both directions).
AOT_KERNELS = (
    "_verify_kernel",
    "_verify_kernel_h2c",
    "_aggregate_verify_kernel",
)


def manifest_signature(entries: dict) -> str:
    """Deterministic signature over a manifest table (see
    MANIFEST_DOMAIN) — used for both the ``entries`` index and the
    autotuned ``plan`` (each carries its own signature, so tampering
    with either is detected independently).  Shared with the
    ``aot-manifest`` / ``tune-plan`` lint families so an audited
    manifest is checked with the byte-identical algorithm."""
    blob = json.dumps(entries, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256((MANIFEST_DOMAIN + blob).encode()).hexdigest()


# Sentinel for _write_manifest: "keep whatever plan the manifest already
# holds" (capture must not drop a tuned plan when it re-signs entries).
_KEEP_PLAN = object()


# ---------------------------------------------------------------------------
# Operand skeletons (the counterpart of the reference's _abstractify)
# ---------------------------------------------------------------------------

_DTYPES = {str(d): d for d in (torch.int32, torch.int64, torch.bool)}


@dataclass(frozen=True)
class Leaf:
    """One operand of a skeleton: a tensor's shape and dtype, and its LFp
    bound (None for a plain tensor)."""

    shape: tuple
    dtype: torch.dtype
    bound: float | None


def skeleton(args) -> bytes:
    """The canonical JSON of an operand tree (LFp and tensor leaves in
    tuples): each leaf as {"bound", "dtype", "shape"}, each tuple as a list.
    It never reads the tensors' contents."""
    def walk(tree):
        if isinstance(tree, F.LFp):
            t, bound = tree.limbs, float(tree.bound)
        elif isinstance(tree, torch.Tensor):
            t, bound = tree, None
        else:
            return [walk(c) for c in tree]
        return {"bound": bound, "dtype": str(t.dtype), "shape": list(t.shape)}

    return json.dumps(walk(args), sort_keys=True, separators=(",", ":")).encode()


def parse_skeleton(data: bytes):
    """The operand tree a skeleton describes, as tuples of ``Leaf``; raises
    ValueError on anything else."""
    def walk(node):
        if isinstance(node, list) and node:
            return tuple(walk(c) for c in node)
        if isinstance(node, dict) and set(node) == {"bound", "dtype", "shape"}:
            dtype, shape, bound = _DTYPES.get(node["dtype"]), node["shape"], node["bound"]
            if (dtype is not None and isinstance(shape, list)
                    and all(type(d) is int and d >= 0 for d in shape)
                    and (bound is None or (type(bound) in (int, float)
                                           and math.isfinite(bound) and bound >= 0))):
                return Leaf(tuple(shape), dtype, None if bound is None else float(bound))
        raise ValueError(f"not an operand skeleton node: {json.dumps(node)[:80]}")

    tree = json.loads(data.decode())
    if not isinstance(tree, list):
        raise ValueError("an operand skeleton is a list of operands")
    return walk(tree)


def operands(skel, device):
    """Zeros of the skeleton's shapes, dtypes and bounds on ``device``: the
    operands a key's program is built from at boot (a build reads shapes,
    dtypes and bounds, never values)."""
    device = torch.device(device)

    def make(node):
        if isinstance(node, Leaf):
            t = torch.zeros(node.shape, dtype=node.dtype, device=device)
            return t if node.bound is None else F.LFp(t, node.bound)
        return tuple(make(c) for c in node)

    return make(skel)


class AotStore:
    """Signed on-disk store of the programs' operand skeletons.

    Layout under ``root``::

        manifest.json        signed index: fingerprint -> entry meta
        <fingerprint>.json   the program's operand skeleton, content-hashed

    Every read path is never-raise: a broken store behaves exactly like
    a cold one (plus a rejects counter and a log line)."""

    def __init__(self, root: str):
        self.root = root
        self.manifest_path = os.path.join(root, "manifest.json")
        self._lock = threading.Lock()  # one read-modify-write of the manifest at a time

    # -- manifest ----------------------------------------------------------

    def entries(self) -> dict:
        """The signature-verified entries table; ``{}`` (plus one reject
        count) when the manifest is absent-after-claiming, corrupt,
        truncated, or its signature does not match."""
        if not os.path.exists(self.manifest_path):
            return {}
        try:
            with open(self.manifest_path, encoding="utf-8") as f:
                doc = json.load(f)
            entries = doc["entries"]
            if doc.get("schema") != MANIFEST_SCHEMA:
                raise ValueError(f"manifest schema {doc.get('schema')!r}")
            if doc.get("signature") != manifest_signature(entries):
                raise ValueError("manifest signature mismatch")
            return entries
        except Exception as exc:  # noqa: BLE001 — never-raise read path
            AOT_CACHE_REJECTS.inc()
            log.warning("AOT manifest rejected: path=%s error=%s", self.manifest_path, exc)
            return {}

    def _read_doc(self) -> dict:
        """Raw manifest document, ``{}`` on any problem (never-raise;
        signature checks happen in :meth:`entries` / :meth:`plan`)."""
        if not os.path.exists(self.manifest_path):
            return {}
        try:
            with open(self.manifest_path, encoding="utf-8") as f:
                return json.load(f)
        except Exception:  # noqa: BLE001 — never-raise read path
            return {}

    def plan(self) -> dict:
        """The signature-verified tuned arm plan (autotune.tune's output:
        device x torch and CUDA versions x kernel sources x per-shape
        winning arms), or ``{}`` when absent, corrupt, or tampered — a bad
        plan behaves exactly like a cold boot."""
        doc = self._read_doc()
        plan = doc.get("plan")
        if not isinstance(plan, dict) or not plan:
            return {}
        if doc.get("plan_signature") != manifest_signature(plan):
            AOT_CACHE_REJECTS.inc()
            log.warning("AOT plan rejected: path=%s error=plan signature mismatch",
                        self.manifest_path)
            return {}
        return plan

    def write_plan(self, plan: dict | None) -> None:
        """Persist (or clear, with ``None``) the tuned plan alongside the
        entries table.  The entries index is re-read and re-signed through
        the verified path, so a tuner can never launder a tampered entries
        table by writing a plan."""
        os.makedirs(self.root, exist_ok=True)
        with self._lock:
            self._write_manifest(self.entries(), plan=plan or None)

    def _write_manifest(self, entries: dict, plan=_KEEP_PLAN) -> None:
        if plan is _KEEP_PLAN:
            # capture() rewrites entries; keep the tuned plan it rides
            # with — but only if the plan still verifies (a tampered
            # plan must not get re-signed into legitimacy).
            held = self.plan()
            plan = held or None
        doc = {
            "schema": MANIFEST_SCHEMA,
            "entries": entries,
            "signature": manifest_signature(entries),
        }
        if plan:
            doc["plan"] = plan
            doc["plan_signature"] = manifest_signature(plan)
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, sort_keys=True, indent=1)
        os.replace(tmp, self.manifest_path)

    # -- capture -----------------------------------------------------------

    def capture(self, call, cache_key, args, kernel: str = "") -> bool:
        """Record a just-built program (``call``: a ``program`` object, with
        its ``fingerprint`` and ``device``) under its fingerprint, with the
        skeleton of its operands ``args``.  Runs on the serving path right
        after a first build, so it must never raise: a failed capture costs
        the next boot a build from traffic, nothing else."""
        try:
            fp_hex = call.fingerprint
            with TRACER.span("aot.capture", fingerprint=fp_hex, kernel=kernel or "?"):
                data = skeleton(args)
                meta = {
                    "kernel": kernel,
                    "cache_key": list(cache_key),
                    "torch": torch.__version__,
                    "cuda": torch.version.cuda,
                    "device": PG.device_name(call.device),
                    "blob": fp_hex + ".json",
                    "sha256": hashlib.sha256(data).hexdigest(),
                    "size": len(data),
                }
                os.makedirs(self.root, exist_ok=True)
                blob_path = os.path.join(self.root, meta["blob"])
                with open(blob_path + ".tmp", "wb") as f:
                    f.write(data)
                os.replace(blob_path + ".tmp", blob_path)
                with self._lock:
                    entries = self.entries()
                    entries[fp_hex] = meta
                    self._write_manifest(entries)
            log.info("AOT program captured: fingerprint=%s kernel=%s bytes=%d",
                     fp_hex, kernel, len(data))
            return True
        except Exception as exc:  # noqa: BLE001 — capture is best-effort
            log.warning("AOT capture failed: kernel=%s error=%s", kernel, exc)
            return False

    # -- load --------------------------------------------------------------

    def load(self, fingerprint: str, meta: dict | None = None):
        """One entry's operand skeleton (``parse_skeleton``'s tree), or None
        (never raises).  Counts ``aot_cache_hits_total`` on success,
        ``_misses_total`` when the store simply has no such program,
        ``_rejects_total`` when an entry exists but fails its hash or does
        not parse."""
        if meta is None:
            meta = self.entries().get(fingerprint)
        if meta is None:
            AOT_CACHE_MISSES.inc()
            return None
        try:
            blob = meta["blob"]
            if os.path.basename(blob) != blob:
                raise ValueError(f"blob {blob!r} is not a file of the store")
            with open(os.path.join(self.root, blob), "rb") as f:
                data = f.read()
            if hashlib.sha256(data).hexdigest() != meta["sha256"]:
                raise ValueError("blob sha256 mismatch")
            skel = parse_skeleton(data)
            AOT_CACHE_HITS.inc()
            return skel
        except Exception as exc:  # noqa: BLE001 — fall back to building from traffic
            AOT_CACHE_REJECTS.inc()
            log.warning("AOT entry rejected: fingerprint=%s error=%s", fingerprint, exc)
            return None


# ---------------------------------------------------------------------------
# The prewarm boot phase
# ---------------------------------------------------------------------------

# the numbers of a key's build record that the report keeps
_BUILD_FIELDS = ("build_s", "warmup_s", "capture_s", "instantiate_s",
                 "instantiate_device_bytes", "instantiate_host_bytes")


@dataclass
class PrewarmReport:
    """What one prewarm pass did, for the boot log and the boot row."""

    loaded: list = field(default_factory=list)     # built from their skeletons
    rejected: list = field(default_factory=list)   # failed integrity or parse
    stale: list = field(default_factory=list)      # other torch/CUDA/device/arm
    compiled: list = field(default_factory=list)   # rejected verify keys built from a probe
    plan_shapes: int = 0                           # tuned shapes installed
    seconds: float = 0.0
    builds: dict = field(default_factory=dict)     # fingerprint -> its build's numbers

    def to_row(self) -> dict:
        return {
            "loaded": len(self.loaded), "rejected": len(self.rejected),
            "stale": len(self.stale), "compiled": len(self.compiled),
            "plan_shapes": self.plan_shapes,
            "seconds": round(self.seconds, 3),
            "builds": self.builds,
        }


def _entry_current(meta: dict, backend) -> bool:
    """The entry matches this process: the same torch and CUDA versions and
    device, a program of AOT_KERNELS, and a key whose arm is the one the
    backend would ask for now: the same ``device_h2c`` (verify keys), the
    plan-resolved mxu plane for its batch (``fp.mxu_for_batch``) and the
    chain and WSM gates in force (the port's key holds all of them; the
    reference's holds only the first two)."""
    if meta.get("torch") != torch.__version__ or meta.get("cuda") != torch.version.cuda:
        return False
    if meta.get("device") != PG.device_name(backend.device):
        return False
    key = meta.get("cache_key")
    if not isinstance(key, list) or len(key) != 5:
        return False
    head, size, mxu, chains, wsm = key
    if not all(isinstance(g, bool) for g in (mxu, chains, wsm)):
        return False
    if head == "agg":
        if meta.get("kernel") != "_aggregate_verify_kernel" or type(size) is not int:
            return False
        batch = size
    else:
        if type(head) is not int or size != bool(backend.device_h2c):
            return False
        if meta.get("kernel") != ("_verify_kernel_h2c" if size else "_verify_kernel"):
            return False
        batch = head
    return (mxu == bool(F.mxu_for_batch(batch)) and chains == bool(F.chains_active())
            and wsm == bool(F.wsm_fused_active()))


def prewarm(backend, store: AotStore, *, compile_misses: bool = False) -> PrewarmReport:
    """Build every current manifest entry's program in ``backend`` from its
    operand skeleton, one ``prewarm.load`` span per entry.

    Runs before the node takes traffic, as the reference orders it: on the
    card a capture must not overlap other work of the process on the
    device.  Entries for another torch or CUDA
    version, device or arm are skipped as stale; entries that fail their
    integrity checks are rejected and, with ``compile_misses``, a rejected
    verify key is built from a probe batch (``warm_compile``) so that the
    store heals on its capture.

    The tuned arm plan installs FIRST: entry currency is judged against the
    plan-resolved arm per batch shape, so the built set is exactly the
    programs the tuned dispatcher will ask for.  A stale or tampered plan
    installs nothing and the pass goes on under the environment's or the
    default arm."""
    report = PrewarmReport()
    t0 = time.perf_counter()
    plan = store.plan()
    if plan:
        from . import autotune

        report.plan_shapes = autotune.install_plan(plan)
    entries = store.entries()
    for fp_hex, meta in sorted(entries.items()):
        if not _entry_current(meta, backend):
            report.stale.append(fp_hex)
            AOT_CACHE_MISSES.inc()
            continue
        key = tuple(meta["cache_key"])
        with TRACER.span("prewarm.load", fingerprint=fp_hex, kernel=meta.get("kernel", "?")):
            skel = store.load(fp_hex, meta)
            if skel is not None and backend.fingerprint_for(key) != fp_hex:
                AOT_CACHE_REJECTS.inc()
                log.warning("AOT entry rejected: fingerprint=%s error=the key's program has "
                            "fingerprint %s here", fp_hex, backend.fingerprint_for(key))
                skel = None
            if skel is None:
                report.rejected.append(fp_hex)
                if compile_misses and _recompile_entry(backend, meta):
                    report.compiled.append(fp_hex)
                continue
            backend.install_program(key, fp_hex, skel)
        report.loaded.append(fp_hex)
        rec = backend.builds[key]
        report.builds[fp_hex] = {k: rec[k] for k in _BUILD_FIELDS if k in rec}
    report.seconds = time.perf_counter() - t0
    log.info("Prewarm finished: %s", report.to_row())
    return report


def _recompile_entry(backend, meta: dict) -> bool:
    """Build the program a rejected entry described through the backend's
    normal (capturing) path, so the store heals.  Only the batch-verify keys
    can be built from their metadata alone."""
    key = meta.get("cache_key") or ()
    if len(key) != 5 or key[0] == "agg":
        return False
    try:
        return bool(backend.warm_compile(int(key[0])))
    except Exception as exc:  # noqa: BLE001 — prewarm must not kill boot
        log.warning("Prewarm rebuild failed: cache_key=%s error=%s", list(key), exc)
        return False


def record_boot_row(row: dict, path: str) -> None:
    """Append a ``kind="boot"`` row to the JSON-lines file ``path``, never
    raising: boot accounting must not be able to fail a boot."""
    try:
        out = {
            "kind": "boot",
            "device_kind": device_kind(),
            "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        }
        out.update(row)
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(out) + "\n")
    except Exception as exc:  # noqa: BLE001 — accounting only
        log.warning("boot history write failed: %s", exc)
