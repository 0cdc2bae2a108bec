"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` into one shared library with a plain
C interface and loaded with ``ctypes``; nothing includes PyTorch's headers,
so a cold build takes seconds. The library lands in
``<checkout>/build/yolo_tpu_torch/<hash>/``, keyed by a hash of the sources
and the flags, so an edited kernel is rebuilt and an unchanged one is reused.

Nothing here runs at import time: the first call to :func:`load` builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "yolo_tpu_torch"
LIB_NAME = "libyolo_tpu_torch_kernels.so"

# sm_90a keeps Hopper's wgmma/setmaxnreg available to later kernels. No
# --use_fast_math and no -fmad=false: kernels that need exact rounding say so
# with the __f*_rn intrinsics.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and"
            " PATH); the CUDA kernels cannot be built"
        )
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.

    The compiler's output (with ptxas' register and spill report) is kept
    beside the library as ``build.log``. Raises RuntimeError on failure.
    """
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cus = [str(p) for p in sources() if p.suffix == ".cu"]
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cus]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load once, and declare every C function's signature."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.yolo_nms.argtypes = [vp, vp, vp, vp, vp, ci, ci, cf, cf, vp]
        lib.yolo_nms.restype = ci
        lib.yolo_cuda_error_string.argtypes = [ci]
        lib.yolo_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if code != 0:
        msg = load().yolo_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: cudaError {code} ({msg})")
