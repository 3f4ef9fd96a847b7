"""Native (C++) runtime components + build-on-demand loader.

The reference's runtime leans on native code through vendored deps (LevelDB,
MDBX, SQLite, blst — SURVEY §2.7); here the native pieces are built from
C++ sources in this directory with g++ at first use and cached as .so files
in its git-ignored ``_build/``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "_build")  # git-ignored: no binary is committed
_LOCK = threading.Lock()
_CACHE: dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    pass


def load(name: str) -> ctypes.CDLL:
    """Build (if stale) and dlopen lib<name>.so from <name>.cpp."""
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        src = os.path.join(_DIR, f"{name}.cpp")
        so = os.path.join(_BUILD, f"lib{name}.so")
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            os.makedirs(_BUILD, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [
                "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                "-o", tmp, src,
            ]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise NativeBuildError(
                    f"g++ failed for {name}: {proc.stderr[-2000:]}"
                )
            os.replace(tmp, so)  # another process may be loading the old one
        lib = ctypes.CDLL(so)
        _CACHE[name] = lib
        return lib
