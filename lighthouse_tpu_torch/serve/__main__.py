"""Run the standalone batch-verification service on the card — no beacon node.

    python -m lighthouse_tpu_torch.serve --port 5053
    python -m lighthouse_tpu_torch.serve --port 0 --flush-margin 0.005
    python -m lighthouse_tpu_torch.serve --port 5053 --rate 500 --burst 1000
    python -m lighthouse_tpu_torch.serve --port 5053 --datadir /var/lib/lh --prewarm --selfcheck

The port's counterpart of the JAX package's ``tools/serve.py``, with the same
flags: selects the ``"torch"`` backend (``TorchBackend`` on the current CUDA
card), builds the full verifier ladder through the shared construction path
(``serve/stack.py``), starts the tick pump and the Beacon-API-shaped HTTP
edge, prints the URL on its first line, and serves until interrupted (or for
``--run-secs``).  Without CUDA it raises: it never falls back to the python
oracle.  Tenants submit with::

    curl -X POST http://127.0.0.1:5053/eth/v1/verify/batch \\
         -d '{"tenant": "vc-7", "deadline_ms": 250, "sets": [...]}'

and poll ``GET /eth/v1/verify/batch/<request_id>`` for verdicts.

Before the service or its listener is made, ``cli.device_boot`` sets the card
up as ``bn`` does (``--datadir``, ``--tune``, ``--prewarm``, ``--selfcheck``,
with ``bn``'s meanings): the kernels' build cache and the AOT store under the
datadir, the tuned arm plan, every stored key built before the first request,
and the known-answer sweep, whose failure exits 1 with no listener opened.
A key is a CUDA graph, which cannot be stored: what the store keeps is the
key's operand skeleton, and ``--prewarm`` builds each key from it (tens of
seconds each) before the "up" line.  A padded size no stored key covers
builds inside its first request, which then misses its deadline with correct
verdicts.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, default=5053, help="HTTP port (0 = ephemeral)")
    ap.add_argument("--flush-margin", type=float, default=0.02,
                    help="seconds of headroom before the oldest pending deadline at which a "
                         "partial batch flushes — the latency/throughput knob")
    ap.add_argument("--default-deadline-ms", type=float, default=250.0,
                    help="deadline for submissions that carry none")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="default per-tenant sustained sets/s")
    ap.add_argument("--burst", type=float, default=400.0,
                    help="default per-tenant token-bucket burst (sets)")
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="default per-tenant pooled-set bound")
    ap.add_argument("--tick-interval", type=float, default=0.002,
                    help="pump period of the dispatch loop (seconds)")
    ap.add_argument("--run-secs", type=float, default=None, help="exit after N seconds")
    ap.add_argument("--datadir", default=None,
                    help="node data directory: the kernels' build cache (kernel_cache/) and "
                         "the AOT store (aot_cache/) live under it (none if unset)")
    ap.add_argument("--prewarm", action="store_true",
                    help="warm-boot phase: build the program of every current entry of the "
                         "AOT store (<datadir>/aot_cache/, populated by earlier runs) and "
                         "build any rejected verify key from a probe BEFORE the service or its "
                         "listener opens, so that no stored key builds inside a request "
                         "(requires --datadir)")
    ap.add_argument("--tune", action="store_true",
                    help="first-contact kernel autotune: run timed trials of every kernel arm "
                         "across the batch-shape ladder on THIS card, persist the winning "
                         "plan into the AOT store's signed manifest, and install it before "
                         "any listener opens; subsequent boots reinstall the plan via "
                         "--prewarm with zero trials (requires --datadir; LIGHTHOUSE_TPU_MXU "
                         "overrides the plan when set)")
    ap.add_argument("--selfcheck", action="store_true",
                    help="boot-time known-answer suite: run the verdict-integrity canary "
                         "corpus through the active backend's batch path AND every verify "
                         "key it holds (pairs with --prewarm, which builds the store's "
                         "working set first), refusing to boot on any verdict mismatch: a "
                         "silently-corrupting device fails the boot, never a tenant")
    args = ap.parse_args(argv)

    import torch

    from ..cli import device_boot
    from ..crypto.bls import api
    from . import ServeApiServer, TenantPolicy, VerifyService

    if not torch.cuda.is_available():
        raise RuntimeError("the verify service runs on a CUDA card, and none is available")
    api.set_backend("torch")
    rc = device_boot(args.datadir, tune=args.tune, prewarm=args.prewarm,
                     selfcheck=args.selfcheck)
    if rc != 0:
        return rc
    service = VerifyService.standalone(
        default_policy=TenantPolicy(rate=args.rate, burst=args.burst, max_queue=args.max_queue),
        flush_margin=args.flush_margin,
        default_deadline_s=args.default_deadline_ms / 1000.0,
    ).start(interval=args.tick_interval)
    server = ServeApiServer(service, port=args.port).start()
    device = getattr(api.get_backend(), "device", "host")
    print(f"verification service up: http://127.0.0.1:{server.port}/eth/v1/verify/batch "
          f"(flush_margin={args.flush_margin}s, device={device})", flush=True)
    try:
        if args.run_secs is not None:
            time.sleep(args.run_secs)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        service.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
