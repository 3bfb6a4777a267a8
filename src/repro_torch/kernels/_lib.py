"""Build and load the port's CUDA kernels (one shared library, ctypes).

All kernels live in ``repro_torch/csrc/*.cu`` behind a plain C interface.
The first call that needs them compiles every source with ``nvcc`` for
``sm_90a`` (one process per source, all started together) and links one
shared library into ``build/kernels/`` at the repository root, named by a
hash of the sources so an edited kernel rebuilds.  Nothing is compiled
or loaded at import time: the CPU tests import every module on a machine
without ``nvcc``.

Each wrapper checks its tensors, allocates outputs with ``torch.empty``,
passes raw pointers plus ``torch.cuda.current_stream()`` and raises if
the C entry point returns a CUDA error.
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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
GENCODE = "arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ["-gencode", GENCODE, "-std=c++17", "-O3", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB = None
BUILD_LOG: str = ""


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME",
                                             "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build() -> Path:
    """Compile and link the kernel library if it is not built yet;
    returns its path.  ``BUILD_LOG`` keeps nvcc's output (ptxas register
    and shared-memory lines included)."""
    global BUILD_LOG
    lib = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs, failed = [], []
        for src, p in zip(_sources(), procs):
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        BUILD_LOG = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{BUILD_LOG}")
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-gencode", GENCODE, "-shared", "-o", str(tmp_lib),
             *map(str, objs), "-lcudart"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        BUILD_LOG += f"\n== link\n{link.stdout}"
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernel library failed:\n"
                               f"{BUILD_LOG}")
        os.replace(tmp_lib, lib)           # atomic: no half-written .so
    (BUILD_DIR / "build.log").write_text(BUILD_LOG)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    P, I, I64, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
    lib.repro_rmsnorm.argtypes = [P, P, P, I64, I, F, I, P]
    lib.repro_rmsnorm.restype = I
    lib.repro_qdq_flat.argtypes = [P, P, P, P, I64, I, I, I, P]
    lib.repro_qdq_flat.restype = I
    lib.repro_flash_fwd.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P, F,
                                    I, I, I, P]
    lib.repro_flash_fwd.restype = I
    lib.repro_codec_ln_rows.argtypes = [P, P, I64, I, I, I, I, P]
    lib.repro_codec_ln_rows.restype = I
    lib.repro_codec_gemm.argtypes = [P, P, P, P, I64, I, I, I, P]
    lib.repro_codec_gemm.restype = I
    lib.repro_codec_gemm_scratch.argtypes = [I64, I, I, I]
    lib.repro_codec_gemm_scratch.restype = I64
    lib.repro_codec_ln_rows_codes.argtypes = [P, P, P, I64, I, I, I, I, P]
    lib.repro_codec_ln_rows_codes.restype = I
    lib.repro_codec_dequant_rows.argtypes = [P, P, P, I64, I, I, I, I, P]
    lib.repro_codec_dequant_rows.restype = I
    lib.repro_quant8_quantize.argtypes = [P, P, P, I64, I, I, I, P]
    lib.repro_quant8_quantize.restype = I
    lib.repro_quant8_dequantize.argtypes = [P, P, P, I64, I, I, I, P]
    lib.repro_quant8_dequantize.restype = I


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            _declare(handle)
            _LIB = handle
        return _LIB


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def dtype_code(t: torch.Tensor, name: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        f"(float32 or bfloat16)")
    return code
