"""The compiled device program: one CUDA graph per program key.

Port of the compiled-program layer of jax_backend/backend.py
(``program_fingerprint``, ``traced_jit`` and the executables that
``JaxBackend._kernel`` caches).  The reference never runs its device
program op by op: ``jax.jit`` traces it once per key and every dispatch is
one call of the executable.  Here the program is captured once per key
into a CUDA graph, and a dispatch copies the marshalled operands into the
graph's static input buffers and replays it: one ``cudaGraphLaunch``
instead of a Python call per kernel.

A key's first call builds it in three steps: static input buffers shaped
like the operands (every leaf on the card, each LFp's bound kept), one
warm-up run of the program on a side stream (which uploads and caches every
device constant, sets the kernels' shared-memory attributes and loads their
modules, none of which may happen inside a capture), then the capture under
``torch.cuda.graph`` and the instantiation, each timed into the key's build
record.  The kernel wrappers' launch counters tick during the warm-up and
the capture and never on a replay.  On the CPU a key's program is the eager
one (``EagerProgram``), and its first call is its build.  Either way a build
is timed into ``JIT_COMPILE_SECONDS`` (the counterpart of ``traced_jit``'s
first-call timing) and then calls the program's ``on_build`` hook, which the
AOT store's capture uses (torch_backend/aot.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import threading
import time

import torch

from ....parallel.mesh import host_pinned, seat_context
from ....utils.metrics import JIT_COMPILE_SECONDS
from . import fp as F


def device_name(device) -> str:
    """The name programs and store entries carry for ``device``: the card's
    name on CUDA, else the device type (``"cpu"``)."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def program_fingerprint(kernel: str, device, **attrs) -> str:
    """Stable per-program fingerprint: the program's name, the key's
    attributes, the PyTorch and CUDA versions and the device's name.  12 hex
    characters, sha256-derived (jax_backend/backend.py:program_fingerprint)."""
    blob = json.dumps({"kernel": kernel, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "device": device_name(device), **attrs},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def map_operands(fn, tree):
    """Apply ``fn(tensor, bound)`` to every leaf of an operand tree (LFp or
    tensor leaves in tuples); LFp leaves come back as LFp."""
    if isinstance(tree, F.LFp):
        return F.LFp(fn(tree.limbs, tree.bound), tree.bound)
    if isinstance(tree, torch.Tensor):
        return fn(tree, None)
    return tuple(map_operands(fn, c) for c in tree)


def _leaves(tree):
    if isinstance(tree, F.LFp):
        return [(tree.limbs, tree.bound)]
    if isinstance(tree, torch.Tensor):
        return [(tree, None)]
    return [leaf for c in tree for leaf in _leaves(c)]


def _pinned(host, device):
    """The operand tree with every host leaf contiguous in pinned memory when
    ``device`` is a card, so that its copy there neither blocks nor waits (a
    slice of a batch, as the pod's shards are, is strided)."""
    if torch.device(device).type != "cuda":
        return host
    return map_operands(lambda t, _: host_pinned(t), host)


def _copy_into(static, host) -> None:
    """Enqueue the copies of the host operands into the static buffers on the
    current stream, from pinned memory and without a host sync.  The
    operands must have the structure, shapes, dtypes and bounds the program
    was captured with: the bounds are static in the captured program."""
    dst, src = _leaves(static), _leaves(host)
    if len(dst) != len(src):
        raise ValueError(f"program operands: {len(src)} leaves, the program takes {len(dst)}")
    for (d, d_bound), (s, s_bound) in zip(dst, src):
        if d.shape != s.shape or d.dtype != s.dtype or d_bound != s_bound:
            raise ValueError(f"program operand {tuple(s.shape)} {s.dtype} bound {s_bound}; "
                             f"the program takes {tuple(d.shape)} {d.dtype} bound {d_bound}")
    for (d, _), (s, _) in zip(dst, src):
        d.copy_(s, non_blocking=True)


# CUgraphNodeType (cuda.h)
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
               6: "wait_event", 7: "event_record", 8: "ext_semas_signal",
               9: "ext_semas_wait", 10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op",
               13: "conditional"}


def graph_node_counts(graph: torch.cuda.CUDAGraph) -> dict:
    """{node type: count} of a captured graph (kept with ``keep_graph``),
    through libcuda's cuGraphGetNodes and cuGraphNodeGetType."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: CUresult {err}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(lib.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(lib.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    counts, kind = {}, ctypes.c_int()
    for node in nodes:
        check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        name = _NODE_TYPES.get(kind.value, str(kind.value))
        counts[name] = counts.get(name, 0) + 1
    return counts


def _host_rss_bytes() -> int:
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class GraphPool:
    """The memory pool every key of one backend captures into, the event
    recorded after the backend's last replay, and the lock that orders the
    replays.  Keys share the pool, so a replay's temporaries may lie where
    another key's were: every replay waits for the one before it (an event,
    no host sync), whatever stream or thread it comes from, and each
    replay's static output is copied out right after it, before another
    replay can run.  ``lock`` makes that sequence one step for each caller:
    a dispatch holds it from reading ``last_replay`` through setting it
    again, and a build holds it for the whole build, so no replay runs
    beside a capture.  A dispatch holds it across no host sync, so a hung
    card never keeps it from another thread."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.handle = torch.cuda.graph_pool_handle()
        self.last_replay: torch.cuda.Event | None = None
        self.lock = threading.Lock()

    def reserved_bytes(self) -> int:
        """Device memory the pool holds: the graphs' working set."""
        segments = torch.cuda.memory._snapshot(self.device)["segments"]
        return sum(seg["total_size"] for seg in segments
                   if tuple(seg["segment_pool_id"]) == tuple(self.handle))


class _Program:
    """What both forms of a key's program share: the key, its arm, its build
    record (``fingerprint`` and the build's numbers), a build made once, also
    when threads race to it, and the ``on_build(program, host_args)`` hook
    called after the build."""

    def __init__(self, fn, key: tuple, arm: tuple, record: dict, on_build=None):
        self.fn = fn
        self.key = key
        self.arm = arm  # (chains, wsm, mxu), held around every run of fn
        self.record = record  # the key's build record, filled by the build
        self.on_build = on_build
        self._lock = threading.Lock()

    @property
    def fingerprint(self) -> str:
        return self.record["fingerprint"]

    @property
    def built(self) -> bool:
        raise NotImplementedError

    def build(self, host_args, capture: bool = True):
        """Build the program from operands shaped like ``host_args`` unless it
        is built already; then, if ``capture``, call ``on_build``.  Returns
        the build's own output where the build runs the program (on the CPU),
        else None."""
        with self._lock:
            if self.built:
                return None
            t0 = time.perf_counter()
            out = self._build(host_args)
            self.record["build_s"] = time.perf_counter() - t0
        JIT_COMPILE_SECONDS.observe(self.record["build_s"])
        if capture and self.on_build is not None:
            self.on_build(self, host_args)
        return out

    def __call__(self, *host_args):
        if not self.built:
            out = self.build(host_args)
            if out is not None:
                return out
        return self._run(host_args)


class EagerProgram(_Program):
    """One key's program on the CPU: the eager program under the key's arm on
    the operands copied to the device.  Its first call is its build (the
    reference's first call traces, compiles and runs)."""

    def __init__(self, fn, key: tuple, arm: tuple, device, record: dict, on_build=None):
        super().__init__(fn, key, arm, record, on_build)
        self.device = torch.device(device)
        self._built = False

    @property
    def built(self) -> bool:
        return self._built

    def _build(self, host_args):
        out = self._run(host_args)
        self._built = True
        return out

    def _run(self, host_args):
        args = map_operands(lambda t, _: F.upload(t, self.device), host_args)
        with torch.inference_mode(), F.pinned_arm(*self.arm):
            return self.fn(*args)


class CapturedProgram(_Program):
    """One key's captured program.  Calling it with the host operands of a
    marshalled batch builds the graph on the first call, then copies the
    operands into the static inputs, replays the graph and returns a fresh
    copy of its one-element verdict tensor, all enqueued on the current
    stream without waiting for the device.  ``build`` makes the graph without
    a replay, from any operands of the key's shapes (warm boot builds it from
    zeros on the card).

    Ordering: the input copies and the replay run on the caller's current
    stream after the backend's previous replay (``GraphPool.last_replay``),
    so dispatch N + 1 overwrites the static inputs only once replay N has
    read them, and replays of keys sharing the pool never overlap, also
    when dispatches come on different streams.  Concurrent callers (the
    pod's shard threads, seats that share a backend) enqueue one at a time
    under ``GraphPool.lock``: each one's copies, replay and output copy
    are enqueued together, so no caller replays with another's operands.
    The returned tensor never aliases the static output."""

    def __init__(self, fn, key: tuple, arm: tuple, pool: GraphPool, record: dict, counts,
                 on_build=None):
        super().__init__(fn, key, arm, record, on_build)
        self.pool = pool
        self.device = pool.device
        self.counts = counts  # the wrappers' launch counts (backend.launch_counts)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.static_in = None
        self.static_out = None

    @property
    def built(self) -> bool:
        return self.graph is not None

    def _run(self, host_args):
        # the graph's card made current: a replay goes to the current
        # card's stream, whichever card the calling thread had current
        with seat_context(self.pool.device), torch.inference_mode():
            stream = torch.cuda.current_stream(self.pool.device)
            # pinning, the output's allocation and the event's creation stay
            # outside the lock: under it only enqueues
            host_args = _pinned(host_args, self.pool.device)
            done = torch.cuda.Event()
            out = torch.empty_like(self.static_out)
            with self.pool.lock:
                if self.pool.last_replay is not None:
                    stream.wait_event(self.pool.last_replay)
                _copy_into(self.static_in, host_args)
                self.graph.replay()
                out.copy_(self.static_out)
                done.record(stream)
                self.pool.last_replay = done
        return out

    def _build(self, host_args) -> None:
        # once per key, before it serves traffic: the build's synchronizes
        # run under the pool's lock, so no replay overlaps the capture
        with self.pool.lock, seat_context(self.pool.device):
            self._build_locked(_pinned(host_args, self.pool.device))

    def _build_locked(self, host_args) -> None:
        dev = self.pool.device
        rec = self.record
        self.static_in = map_operands(
            lambda t, _: torch.empty(t.shape, dtype=t.dtype, device=dev), host_args)
        main = torch.cuda.current_stream(dev)
        if self.pool.last_replay is not None:
            main.wait_event(self.pool.last_replay)
        _copy_into(self.static_in, host_args)
        # the warm-up: fills every cache of device constants and runs each
        # kernel's one-time setup outside the capture (F.upload refuses a
        # copy inside one)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        t0 = time.perf_counter()
        with torch.cuda.stream(side), torch.inference_mode(), F.pinned_arm(*self.arm):
            self.fn(*self.static_in)
        main.wait_stream(side)
        torch.cuda.synchronize(dev)
        rec["warmup_s"] = time.perf_counter() - t0

        before = self.counts()
        rss0 = _host_rss_bytes()
        torch.cuda.reset_peak_memory_stats(dev)
        live0 = torch.cuda.memory_allocated(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        try:
            # thread_local: another thread's work on the card (another
            # backend's seat, a marshal's gather) neither fails the capture
            # nor is captured into it
            with torch.cuda.graph(graph, pool=self.pool.handle,
                                  capture_error_mode="thread_local"), \
                    torch.inference_mode(), F.pinned_arm(*self.arm):
                out = self.fn(*self.static_in)
        except Exception as exc:
            raise RuntimeError(f"capture of program {self.key} failed: {exc}") from exc
        rec["capture_s"] = time.perf_counter() - t0
        rec["capture_peak_bytes"] = torch.cuda.max_memory_allocated(dev) - live0
        rec["pool_bytes"] = self.pool.reserved_bytes()
        after = self.counts()
        rec["launches"] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        rec["nodes"] = graph_node_counts(graph)
        rec["capture_host_bytes"] = _host_rss_bytes() - rss0
        rss0 = _host_rss_bytes()
        free0 = torch.cuda.mem_get_info(dev)[0]
        t0 = time.perf_counter()
        try:
            graph.instantiate()
            torch.cuda.synchronize(dev)
        except Exception as exc:
            raise RuntimeError(f"instantiation of program {self.key} failed: {exc}") from exc
        rec["instantiate_s"] = time.perf_counter() - t0
        rec["instantiate_device_bytes"] = free0 - torch.cuda.mem_get_info(dev)[0]
        rec["instantiate_host_bytes"] = _host_rss_bytes() - rss0
        self.graph, self.static_out = graph, out
