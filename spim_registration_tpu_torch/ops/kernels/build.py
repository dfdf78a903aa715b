"""Build and load the hand-written CUDA kernels of `csrc/`.

Each source is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface and loaded with `ctypes` — a few seconds
per source, where a build that includes PyTorch's headers takes minutes.
Libraries are built at first use into `_build/` beside the package
(listed in `.gitignore`), named by a hash of the source and flags so an
edited source rebuilds. `build_all()` starts one `nvcc` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("zpass", "sl_rows", "segtopk", "dog", "zfused", "rl_update")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{h}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is already built.
    Returns (target, process or None)."""
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: Path, job) -> None:
    if job is None:
        return
    proc, tmp = job
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> dict:
    """Compile every source that is not built yet, all at once; returns
    {name: library path}."""
    with _lock:
        jobs = {n: _start(n) for n in SOURCES}
        for n, (out, job) in jobs.items():
            _finish(n, out, job)
        return {n: out for n, (out, _) in jobs.items()}


def build_log(name: str) -> str:
    """nvcc's output (ptxas register / shared-memory report) of the last
    build of `name` in this checkout, or '' when it was not built here."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            out, job = _start(name)
            _finish(name, out, job)
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
    return lib
