"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` entry points and is
compiled on first use into ``csrc/build/lib<name>-<hash>.so`` (the hash is
of the source and the flags, so an edited source rebuilds and a stale
library is never loaded). A plain C interface builds in seconds, where a
source that includes PyTorch's headers takes minutes. Nothing here runs at
import time: this module is imported on machines without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per-kernel build record: seconds spent in nvcc (0.0 when a cached
# library was loaded) and the ptxas resource report
build_info: dict[str, dict] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, pathlib.Path, pathlib.Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = _lib_path(name)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, pathlib.Path(tmp), target


def build(names: list[str]) -> dict[str, dict]:
    """Compile every named kernel whose library is missing, all nvcc
    processes started together; returns ``build_info`` for ``names``.
    Raises with nvcc's output when a build fails."""
    with _lock:
        t0 = time.perf_counter()
        running = {}
        for name in names:
            if _lib_path(name).exists():
                build_info.setdefault(name, {"seconds": 0.0, "ptxas": ""})
            else:
                running[name] = _start_build(name)
        errors = []
        for name, (proc, tmp, target) in running.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"nvcc failed for {name}.cu:\n{out}")
                continue
            os.replace(tmp, target)
            build_info[name] = {"seconds": time.perf_counter() - t0,
                                "ptxas": out.strip()}
        if errors:
            raise RuntimeError("\n".join(errors))
        return {name: build_info[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                _libs[name] = lib
    return lib
