"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc``, all started together, and the
objects are linked into one shared library with a plain C interface, loaded
with ``ctypes``; nothing includes PyTorch's headers, so a cold build takes
seconds. The library lands in
``<checkout>/build/yolo_tpu_torch/<hash>/``, keyed by a hash of the sources
and the flags, so an edited kernel is rebuilt and an unchanged one is reused.

Nothing here runs at import time: the first call to :func:`load` builds.

Every wrapper calls its C entry point through :func:`launch`: the device
guard, the current stream, the error check and the count in
:data:`LAUNCHES` live here, and an entry point's signature is its line of
:data:`SIGNATURES`.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from yolo_tpu_torch.utils import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "yolo_tpu_torch"
LIB_NAME = "libyolo_tpu_torch_kernels.so"

# sm_90a keeps Hopper's wgmma/setmaxnreg available to later kernels. No
# --use_fast_math and no -fmad=false: kernels that need exact rounding say so
# with the __f*_rn intrinsics.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_vp, _ci, _cf, _cd, _cll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double,
                            ctypes.c_longlong)
_ptrs, _int_out = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)

#: Each C entry point's argument types, its last argument the stream
#: :func:`launch` appends. Each returns a cudaError_t as an int.
SIGNATURES = {
    "yolo_nms": [_vp, _vp, _vp, _vp, _vp, _ci, _ci, _cf, _cf, _vp],
    "yolo_nms_f64": [_vp, _vp, _vp, _vp, _vp, _ci, _ci, _cd, _cd, _vp],
    "yolo_empty": [_ci, _ci, _vp],
    "yolo_bn_stats": [_vp, _vp, _vp, _cll, _ci, _ci, _ci, _vp],
    "yolo_bn_normalize": [_vp, _vp, _vp, _vp, _cll, _ci, _ci, _ci, _ci, _vp],
    "yolo_bn_bwd_reduce": [_vp, _vp, _vp, _vp, _vp, _vp, _cll, _ci, _ci, _ci, _ci, _vp],
    "yolo_bn_bwd_dx": [_vp, _vp, _vp, _vp, _vp, _vp, _cll, _ci, _ci, _ci, _ci, _vp],
    "yolo_quant_s2d": [_vp, _ci, _vp, _vp, _ci, _ci, _ci, _cf, _cf, _cf, _cf, _cf, _cf, _vp],
    "yolo_dynq": [_vp, _cll, _vp, _vp, _ci, _vp],
    "yolo_max_pool_int8": [_vp, _vp, _ci, _ci, _ci, _ci, _vp],
    "yolo_int8_conv": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, *([_ci] * 16), _vp, _vp],
    "yolo_int8_bottleneck": [_vp, _vp, _ptrs, *([_ci] * 7), _int_out, _vp],
    "yolo_int8_chain": [_vp, _vp, _vp, _vp, _ptrs, *([_ci] * 9), _int_out, _vp],
    "yolo_int8_wino_taps": [_vp, _vp, _vp, *([_ci] * 6), _vp],
    "yolo_int8_wino_gemm": [_vp, _vp, _vp, _vp, _vp, *([_ci] * 8), _vp],
    "yolo_adam_update": [_vp, _vp, _vp, _vp, _vp, _cll, _vp],
    "yolo_bf16_conv3x3": [_vp, _vp, _vp, _vp, _vp, *([_ci] * 6), _vp],
    "yolo_bf16_bottleneck": [*([_vp] * 8), *([_ci] * 7), _vp],
}

#: Successful calls of each C entry point, by its name. A CUDA graph's
#: replay calls none: its launches count once, at capture.
LAUNCHES: collections.Counter = collections.Counter()

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

    One ``nvcc -c`` per source runs in parallel; one more links the objects.
    The compilers' output (with ptxas' register and spill report) is kept
    beside the library as ``build.log``. Raises RuntimeError on failure.
    """
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = os.getpid()
    cmds = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(out.parent / f"{src.stem}.{tag}.o"), str(src)]
        for src in sources() if src.suffix == ".cu"
    ]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        text, _ = proc.communicate()
        logs.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (exit {proc.returncode}):\n{text}")
    if not failed:
        tmp = out.with_name(f"{LIB_NAME}.{tag}.tmp")
        link = [nvcc, "-shared", "-o", str(tmp), *(cmd[cmd.index("-o") + 1] for cmd in cmds)]
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    (out.parent / "build.log").write_text("".join(logs))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load once, and declare every C function's signature."""
    global _lib
    if _lib is None:
        with tracing.span("kernels.load"):
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            lib.yolo_cuda_error_string.argtypes = [ctypes.c_int]
            lib.yolo_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if code != 0:
        msg = load().yolo_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: cudaError {code} ({msg})")


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and the current stream
    of ``device`` (a CUDA tensor's device) as its last argument; raise if it
    fails, else count it in :data:`LAUNCHES`.

    The kernels launch on the current device, so its guard is entered only
    when ``device`` is another: entering it costs host time on every call.
    """
    index = device.index
    guard = (contextlib.nullcontext() if index == torch.cuda.current_device()
             else torch.cuda.device(index))
    with guard:
        code = getattr(load(), name)(*args, torch._C._cuda_getCurrentRawStream(index))
    check(code, f"{name} launch")
    LAUNCHES[name] += 1
