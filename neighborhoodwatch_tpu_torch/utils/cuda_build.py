"""Build a kernel source under `csrc/` into a shared library with a plain C
interface and load it with ctypes.

`nvcc -gencode arch=compute_90a,code=sm_90a` compiles one `csrc/<name>.cu`
into `_build/lib<name>-<hash>.so` at first use (the hash covers the source
and the flags, so an edited source rebuilds). Nothing is built at import
time: the CPU test environment has neither nvcc nor a card.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> tuple[str, str]:
    """Compile csrc/<name>.cu unless the hashed library already exists.
    Returns (library path, ptxas report of registers and spills; empty
    when the library was already built)."""
    out = library_path(name)
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    os.replace(tmp, out)
    return out, res.stderr


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; one handle per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)[0])
            _loaded[name] = lib
        return lib
