"""Build and load the port's CUDA kernels: ``nvcc`` compiles every
``csrc/*.cu`` for ``sm_90a`` (one process per source, all started
together), links one shared library with a plain C interface, and
``ctypes`` loads it.

The build runs at the first kernel launch, never at import, and is keyed
by a hash of the sources and flags: ``build/repro_torch_kernels/<hash>/``
under the checkout (git-ignored).  A finished build is reused.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -v: registers; --split-compile=0: optimize and assemble a source's kernels on every
# core (paged_attention.cu holds 75 kernel instantiations)
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0"]
LIB_NAME = "librepro_torch_kernels.so"

_lib: Optional[ctypes.CDLL] = None
build_log = ""  # ptxas register/shared-memory report of the last build


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", "") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global build_log
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        log = out_dir / "build.log"
        build_log = log.read_text() if log.exists() else ""
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    procs = []
    for src in _sources():
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    logs, objs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp_lib = tmp / LIB_NAME
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    (out_dir / "build.log").write_text(build_log)
    os.replace(tmp_lib, lib)  # atomic: a concurrent loader never sees half a file
    shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use; C signatures declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fixedpoint_matmul_launch.argtypes = [
            P, P, P, P, P, P, I, I, I, I, I, I, I, I, P,
        ]
        lib.fixedpoint_matmul_launch.restype = I
        lib.fixedpoint_matmul_experts_launch.argtypes = [
            P, P, P, P, P, I, I, I, I, I, I, I, I, I, P,
        ]
        lib.fixedpoint_matmul_experts_launch.restype = I
        lib.fixedpoint_matmul_tc_launch.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, P]
        lib.fixedpoint_matmul_tc_launch.restype = I
        lib.fixedpoint_matmul_experts_tc_launch.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I,
                                                             P]
        lib.fixedpoint_matmul_experts_tc_launch.restype = I
        lib.fixedpoint_matmul_decode_launch.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                                                         I, I, P]
        lib.fixedpoint_matmul_decode_launch.restype = I
        lib.paged_attention_launch.argtypes = [
            P, P, P, P, P, P, P, P,
            I, I, I, I, I, I, I, I, I, I, I,
            F, F, F, P,
        ]
        lib.paged_attention_launch.restype = I
        lib.paged_attention_mla_launch.argtypes = [
            P, P, P, P, P, P, P, P, P, P, P, P,
            I, I, I, I, I, I, I, I, I, I,
            F, F, P,
        ]
        lib.paged_attention_mla_launch.restype = I
        lib.paged_attention_mla_tc_launch.argtypes = [
            P, P, P, P, P, P, P, P, P,
            I, I, I, I, I, I, I, I, I,
            F, F, P,
        ]
        lib.paged_attention_mla_tc_launch.restype = I
        L = ctypes.c_longlong
        lib.symog_update_launch.argtypes = [P, P, P, P, P, L, L, F, F, F, F, F, I, P]
        lib.symog_update_launch.restype = I
        lib.symog_sqnorm_launch.argtypes = [P, P, P, L, L, F, F, P, P, P, I, P]
        lib.symog_sqnorm_launch.restype = I
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of ``device`` (cached: queried once)."""
    return _sm_count(device.index if device.index is not None else 0)


def current_stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device`` as a raw handle."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)  # skips a Stream object
    if raw is not None:
        return ctypes.c_void_p(raw(device.index if device.index is not None else 0))
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
