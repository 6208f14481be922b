"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``. The build happens at first
use, into ``build/<hash>/`` at the repository root, where ``<hash>`` covers
every source and the compiler flags, so an edited source rebuilds and an
unchanged one is reused. ``build_all`` starts one ``nvcc`` per source, all
at once. Nothing here runs at import time.
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
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": float, "log": str, "path": str} for the builds this
# process ran or found
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, dict]:
    """Compile every source that has no library yet, one ``nvcc`` each, all
    started together; raise with the compiler's output if any fails."""
    with _LOCK:
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, src in _sources().items():
            lib = out_dir / f"lib{name}.so"
            if lib.exists():
                BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "cached",
                                             "path": str(lib)})
                continue
            tmp = out_dir / f".lib{name}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, lib, time.perf_counter())
        failed = []
        for name, (proc, tmp, lib, t0) in procs.items():
            log, _ = proc.communicate()
            secs = time.perf_counter() - t0
            (out_dir / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
                continue
            os.replace(tmp, lib)       # atomic: concurrent builders agree
            BUILD_INFO[name] = {"seconds": secs, "log": log, "path": str(lib)}
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return dict(BUILD_INFO)


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        if name not in _sources():
            raise KeyError(f"no kernel source csrc/{name}.cu")
        build_all()
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = _LIBS[name] = ctypes.CDLL(BUILD_INFO[name]["path"])
    return lib
