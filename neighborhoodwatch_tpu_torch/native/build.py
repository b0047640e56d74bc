"""Build the native IO library (native/nwio.cpp) with g++ or clang++.

    python -m neighborhoodwatch_tpu_torch.native.build

or let native/nwio.py build it at first use. The library goes to
`_build/libnwio-<hash>.so`, the hash covering the source and the flags, so
an edited source rebuilds. The compiler writes a file of its own process
and `os.replace` moves it into place: a process that finds the library
finds a whole one, however many build it at once.
"""

import hashlib
import os
import shutil
import subprocess
import sys
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "nwio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall"]


def compiler() -> str | None:
    return shutil.which("g++") or shutil.which("clang++")


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        digest.update(b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libnwio-{digest.hexdigest()[:16]}.so")


def build() -> str | None:
    """Path of the built library (compiled now unless it exists), or None
    when there is no compiler. A compile error raises with the compiler's
    stderr."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = compiler()
    if cxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SRC],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"{cxx} failed for {SRC}:\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


if __name__ == "__main__":
    path = build()
    if path is None:
        sys.exit("no C++ compiler (g++ or clang++) on PATH")
    print(path)
