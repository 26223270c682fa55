"""Builds a hand-written CUDA kernel (knnsvc_torch/csrc/<name>.cu) at first
use and loads it with ctypes.

The source is compiled by nvcc for Hopper (sm_90a) into a shared library
with a plain C interface — no PyTorch headers, so a build takes seconds, not
minutes. Libraries go to csrc/build/ (listed in .gitignore), named by a hash
of the source and the flags, so an edited source is never served by a stale
library. Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_LIBS: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class KernelBuild:
    name: str
    library: Path
    ptxas: list[str]      # nvcc -Xptxas -v lines; empty when a built library was reused


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels "
                       "of knnsvc_torch are built with the CUDA toolkit")


def build_kernel(name: str) -> KernelBuild:
    """Compile csrc/<name>.cu unless an up-to-date library exists. Raises
    RuntimeError with nvcc's output if the build fails."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"lib{name}_{digest[:12]}.so"
    if lib.exists():
        return KernelBuild(name, lib, [])
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # written under another name first, so a killed build leaves no library
    tmp = lib.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel {name}: nvcc exit {proc.returncode}\n{log}")
    os.replace(tmp, lib)
    ptxas = [ln.strip() for ln in log.splitlines() if "ptxas" in ln or "spill" in ln]
    return KernelBuild(name, lib, ptxas)


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it on first use."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build_kernel(name).library))
        lib.knnsvc_cuda_error_string.restype = ctypes.c_char_p
        lib.knnsvc_cuda_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return _LIBS[name]


def check_launch(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.knnsvc_cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} (cudaError {code})")
