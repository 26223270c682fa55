"""Loader for the C++ libraries under native/ (ctypes) — the port's own copy
of knnsvc_tpu/native_util.py, onto the same native/ tree.

Builds the native tree with `make -C native` on first use; callers attach
their own symbol signatures to the returned CDLL.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_BUILD_LOCK = threading.Lock()


def load_native_library(lib_name: str, component: str) -> ctypes.CDLL:
    """Load native/build/<lib_name>, building the native tree on first use.
    Raises OSError when the toolchain is unavailable (callers treat that as
    'native path absent' and fall back)."""
    lib_path = NATIVE_DIR / "build" / lib_name
    if not lib_path.exists():
        with _BUILD_LOCK:
            if not lib_path.exists():
                try:
                    subprocess.run(["make", "-C", str(NATIVE_DIR)], check=True,
                                   capture_output=True, timeout=300)
                except (subprocess.SubprocessError, FileNotFoundError) as e:
                    raise OSError(f"{component} native lib not built: {e}") from e
    return ctypes.CDLL(str(lib_path))
