"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``.cu`` file under ``upgdm_tpu_torch/csrc/`` is compiled by its own
``nvcc`` process (all started together) for ``sm_90a`` and the objects are
linked into one shared library with a plain C interface. The library lands
in ``build/kernels/`` at the repository root, named by a hash of the
sources, so an edited source never reuses a stale build. Nothing is built
when a module is imported: the first kernel call builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "build_library", "load_library", "check"]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ["-std=c++17", "-O3", ARCH, "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the last build (ptxas register/spill report)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def build_library() -> Path:
    """Compile csrc/*.cu in parallel and link them; returns the .so path."""
    global build_log
    cu, headers = _sources()
    digest = hashlib.sha256()
    for p in cu + headers:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    lib_path = BUILD_DIR / f"libupgdm_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in cu:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
        tmp_lib = Path(tmp) / lib_path.name
        link = [nvcc, ARCH, "-shared", "-o", str(tmp_lib)] + [str(o) for _, o, _ in procs]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_lib, lib_path)
    return lib_path


def _declare(lib):
    p, i, ll, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint64
    lib.upgdm_fused_denoiser.argtypes = [p, ll, i, p, p, p, p, p, p, p, p, p, p, p, p, p,
                                         p, p, i, p]
    lib.upgdm_fused_denoiser.restype = i
    lib.upgdm_chain_resident.argtypes = [p, p, ll, i, i, p, u64, i, i, p, p, p, p, p, p, p,
                                         p, p, p, p, p, p, p, p, i, p]
    lib.upgdm_chain_resident.restype = i
    lib.upgdm_fused_tmdm.argtypes = [p, ll, i, p, p, p, p, p, p, p, p, p, p, p, p, i, p]
    lib.upgdm_fused_tmdm.restype = i
    lib.upgdm_error_string.argtypes = [i]
    lib.upgdm_error_string.restype = ctypes.c_char_p


def load_library():
    """The loaded kernel library (built on first call in this process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            _declare(lib)
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        msg = load_library().upgdm_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
