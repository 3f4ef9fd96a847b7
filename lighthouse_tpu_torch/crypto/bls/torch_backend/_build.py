"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with nvcc into its own shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds, not minutes).  Libraries go to
``<root>/<hash>/``, keyed by a hash of every file in ``csrc/`` plus the
flags, and are built at first use; all missing libraries are compiled in
parallel, one nvcc process each.  The root is ``lighthouse_tpu_torch/_build/``
unless ``set_build_root`` (``backend.enable_compile_cache``) points it at a
cache directory that outlives the checkout; ``nvcc_runs`` counts the nvcc
processes started, so a warm boot can show that it started none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_ROOT = Path(__file__).resolve().parents[3]
CSRC = PKG_ROOT / "csrc"
BUILD_ROOT = PKG_ROOT / "_build"
# csrc/<name>.cu -> lib<name>.so
LIBRARIES = ("mont", "miller_step", "chain", "wsm_step", "mxu", "miller_step_mxu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
nvcc_runs = 0  # nvcc processes started by build_all in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def set_build_root(root) -> Path:
    """Build and load the libraries under ``root`` from now on (made if
    missing; it must be writable).  Libraries are cached by name once
    loaded, so moving the root after one has loaded would leave a handle
    from the old root beside libraries from the new one: that raises, as
    does a root that cannot be made or written."""
    global BUILD_ROOT
    root = Path(root).resolve()
    with _LOCK:
        if _LOADED and root != Path(BUILD_ROOT).resolve():
            raise RuntimeError(f"libraries {sorted(_LOADED)} are loaded from {BUILD_ROOT}; "
                               f"the build root cannot move to {root}")
        root.mkdir(parents=True, exist_ok=True)
        probe = root / f".write-probe.{os.getpid()}"
        probe.write_bytes(b"")
        probe.unlink()
        BUILD_ROOT = root
    return root


def build_all() -> dict:
    """Compile every library that is not built yet, all nvcc processes
    started together.  Returns {"seconds": wall time, "built": [names],
    "ptxas": {name: [ptxas's entry-function, register and nonzero
    stack/spill lines]}}; raises with nvcc's output if any compile fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    global nvcc_runs
    t0 = time.perf_counter()
    procs = {}
    for name in LIBRARIES:
        target = out_dir / f"lib{name}.so"
        if target.exists():
            continue
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, target)
        nvcc_runs += 1
    ptxas, failures = {}, []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log[-4000:]}")
            continue
        os.replace(tmp, target)
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "entry function" in ln or "registers" in ln
                       or ("spill" in ln and not ln.strip().startswith("0 bytes stack"))]
    if failures:
        raise RuntimeError("\n".join(failures))
    return {"seconds": time.perf_counter() - t0, "built": sorted(procs),
            "ptxas": ptxas}


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if missing."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LOADED:
            path = build_dir() / f"lib{name}.so"
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            lib.lh_error_string.argtypes = [ctypes.c_int]
            lib.lh_error_string.restype = ctypes.c_char_p
            _LOADED[name] = lib
    return _LOADED[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        msg = lib.lh_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
