"""Command-line pieces of the port.

The first piece of the port's counterpart of the JAX package's ``cli.py``:
``device_boot``, the device block that ``bn`` runs before it builds its chain
or opens any listener (``cli.py:264-345`` there), in the same order:

1. the kernels' build cache under ``<datadir>/kernel_cache``
   (``backend.enable_compile_cache``: a restart on the same sources starts
   no nvcc);
2. an ``aot.AotStore`` under ``<datadir>/aot_cache``, attached to the active
   backend, so that each key's first build records its operand skeleton;
3. ``tune``: ``autotune.tune_and_store`` (best-effort: a failed tune is logged
   and the boot goes on);
4. ``prewarm``: ``aot.prewarm(..., compile_misses=True)``, its report logged
   and appended as a boot row to ``<datadir>/boot_history.jsonl``;
5. ``selfcheck``: ``integrity.run_selfcheck()`` over the keys prewarm built; a
   mismatch is logged and the boot refused (return 1).

``python -m lighthouse_tpu_torch.serve`` runs it between ``set_backend("torch")``
and its first listener; ``bn`` itself is not ported yet.
"""

from __future__ import annotations

import logging
import os
import time

from .utils.logging import get_logger, log_with

KERNEL_CACHE = "kernel_cache"  # <datadir>/kernel_cache/<source hash>/lib*.so
AOT_CACHE = "aot_cache"
BOOT_HISTORY = "boot_history.jsonl"


def device_boot(datadir: str | None, *, tune: bool = False, prewarm: bool = False,
                selfcheck: bool = False) -> int:
    """Set up the active BLS backend's device before any listener opens.
    Returns 0, or 1 when the selfcheck finds a wrong verdict (the caller
    must then open nothing)."""
    log = get_logger("bn")
    if datadir:
        from .crypto.bls.torch_backend.backend import enable_compile_cache

        os.makedirs(datadir, exist_ok=True)
        cache_dir = os.path.join(datadir, KERNEL_CACHE)
        if enable_compile_cache(cache_dir):
            log_with(log, logging.INFO, "Kernel compile cache enabled", path=cache_dir)
        else:
            log_with(log, logging.WARNING, "Kernel compile cache unavailable", path=cache_dir)

        from .crypto.bls import api as _bls_api
        from .crypto.bls.torch_backend import aot as _aot

        backend = _bls_api.get_backend()
        if hasattr(backend, "attach_aot_store"):
            aot_store = _aot.AotStore(os.path.join(datadir, AOT_CACHE))
            backend.attach_aot_store(aot_store)
            if tune:
                # before prewarm, so that prewarm (and every later boot's)
                # judges its entries against the tuned routing
                try:
                    from .crypto.bls.torch_backend import autotune as _autotune

                    t_tune = time.perf_counter()
                    plan = _autotune.tune_and_store(aot_store)
                    log_with(log, logging.INFO, "Kernel autotune done",
                             device_kind=plan.get("device_kind"),
                             shapes=len(plan.get("shapes", {})),
                             wall_s=round(time.perf_counter() - t_tune, 3))
                except Exception as exc:  # noqa: BLE001 — tune is optional
                    log_with(log, logging.WARNING, "Kernel autotune failed", error=str(exc))
            if prewarm:
                from .crypto.bls.torch_backend import _build

                nvcc0 = _build.nvcc_runs
                t_warm = time.perf_counter()
                report = _aot.prewarm(backend, aot_store, compile_misses=True)
                row = dict(report.to_row(), nvcc_runs=_build.nvcc_runs - nvcc0)
                log_with(log, logging.INFO, "Prewarm boot phase done", **row)
                _aot.record_boot_row(
                    dict(row, phase="prewarm", wall_s=round(time.perf_counter() - t_warm, 3)),
                    os.path.join(datadir, BOOT_HISTORY))
        elif prewarm or tune:
            log_with(log, logging.WARNING,
                     "--prewarm/--tune: active BLS backend has no AOT seam",
                     backend=getattr(backend, "name", "?"))
    elif prewarm or tune:
        log_with(log, logging.WARNING,
                 "--prewarm/--tune needs --datadir (the store lives under it); skipping")
    if selfcheck:
        # after prewarm, so that the sweep covers the keys it built; before
        # any listener, so that a lying device never serves
        from .integrity import run_selfcheck

        t_chk = time.perf_counter()
        chk = run_selfcheck()
        log_with(log, logging.INFO, "Integrity selfcheck done",
                 ok=chk.ok, checked=chk.checked,
                 kernel_batches=",".join(map(str, chk.batch_sizes)) or "-",
                 wall_s=round(time.perf_counter() - t_chk, 3))
        if not chk.ok:
            for line in chk.mismatches:
                log_with(log, logging.ERROR, "Selfcheck mismatch", detail=line)
            log_with(log, logging.ERROR, "Integrity selfcheck FAILED; refusing to boot")
            return 1
    return 0
