"""Per-tap int8 Winograd F(2,3) conv through the CUDA kernel ``csrc/int8_wino.cu``.

Port of the TPU kernel yolo_tpu/serving/pallas_wino.py::_wino_kernel (entry
``_wino_conv``, public ``conv3x3_wino_pallas``), and of its ablation
variants in experiments/wino_ablate.py::kernel_variant as the kernel's
``mode``:

- ``"full"``: the conv, :func:`conv3x3_wino` (tap build, per-tap requant,
  16 int8 tap dots, dequant, inverse transform, bias, leaky or ReLU, int8);
- ``"taps"``: the tap build and requant only; output (2i + r, 2j + s, k) is
  tap ``p = 2r + s`` of tile (i, j) at channel k (needs K <= C);
- ``"dots"``: the tap build skipped; the dots, dequant, inverse and
  epilogue run on all-zero taps, so every output is ``q(act(t_k))``;
- ``"dots-raw"``: the 16 dots on zero taps; the epilogue runs on the raw
  accumulators of taps 12-15 (no dequant, no inverse), ``q(act(0 + t_k))``.

Its twins are :func:`conv3x3_wino_reference` (``winograd.conv3x3_wino_rq``)
and :func:`wino_ablate_reference`; the kernel equals them bit for bit. On
CPU tensors the wrappers run the twins. A CUDA tensor never reaches a twin:
the kernel runs or the call raises. The kernel takes int8 NHWC activations
at any N, H and W (odd and non-square included), C and K in multiples of 64,
16-byte aligned, and the weight taps packed K-major per tap, ``uk`` (16, K,
C) (:func:`pack_taps`; ``engine.to_device`` stores it beside ``uq``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from yolo_tpu_torch.serving import winograd

#: Kernel launches per mode since the counts were last reset (set each to 0 to reset).
LAUNCHES = {"full": 0, "taps": 0, "dots": 0, "dots-raw": 0}

MODES = {"full": 0, "taps": 1, "dots": 2, "dots-raw": 3}
ALIGN = 64  # channel granularity of the kernel (C chunks and K column blocks)


def pack_taps(uq: torch.Tensor) -> torch.Tensor:
    """U (16, C, K) int8 -> (16, K, C) int8, C contiguous (the kernel's B operand)."""
    return uq.permute(0, 2, 1).contiguous()


def tiles(h: int, w: int) -> Tuple[int, int]:
    """The kernel's 2x2 output tiles a side (rows, columns)."""
    return (h + 1) // 2, (w + 1) // 2


# ------------------------------------------------------------------ twins
def conv3x3_wino_reference(x_q: torch.Tensor, qc: Dict, leaky: bool = True) -> torch.Tensor:
    """The kernel's function in plain torch (``winograd.conv3x3_wino_rq``)."""
    return winograd.conv3x3_wino_rq(x_q, qc, leaky)


def wino_ablate_reference(x_q: torch.Tensor, qw: Dict, mode: str) -> torch.Tensor:
    """What each ablation mode outputs, in plain torch (module docstring); the
    epilogue is the head convs' leaky one, as in the TPU ablation."""
    n, h, w, c = x_q.shape
    k = qw["uq"].shape[-1]
    if mode == "full":
        return winograd.conv3x3_wino_rq(x_q, {"wino": qw}, leaky=True)
    if mode == "taps":
        n_tiles = (max(h, w) + 1) // 2
        vq = winograd.tap_requant(x_q, qw["dinv"], n_tiles)
        return winograd.scatter([vq[p, :, :k] for p in range(4)], n, n_tiles, h, w)
    if mode in ("dots", "dots-raw"):
        y = winograd.activate(qw["t"].float().reshape(1, k), leaky=True)
        return y.expand(n * h * w, k).reshape(n, h, w, k).contiguous()
    raise ValueError(f"wino mode must be one of {sorted(MODES)}, got {mode!r}")


# ------------------------------------------------------------------ kernel
def _check(x_q: torch.Tensor, qw: Dict, uk: torch.Tensor, mode: str) -> None:
    dev = x_q.device
    if x_q.dtype != torch.int8 or x_q.dim() != 4 or not x_q.is_contiguous():
        raise ValueError(f"int8_wino: x must be contiguous (N, H, W, C) int8, got "
                         f"{x_q.dtype} {tuple(x_q.shape)}")
    n, h, w, c = x_q.shape
    k = qw["uq"].shape[-1]
    if c % ALIGN or k % ALIGN:
        raise ValueError(f"int8_wino: the kernel takes C and K in multiples of {ALIGN}, got "
                         f"{c} -> {k}")
    if min(n, h, w) < 1:
        raise ValueError(f"int8_wino: x must not be empty, got {tuple(x_q.shape)}")
    if mode == "taps" and k > c:
        raise ValueError(f"int8_wino: mode 'taps' writes input channels, needs K <= C, got "
                         f"{c} -> {k}")
    if uk.dtype != torch.int8 or tuple(uk.shape) != (16, k, c) or not uk.is_contiguous():
        raise ValueError(f"int8_wino: packed taps must be contiguous (16, {k}, {c}) int8, got "
                         f"{uk.dtype} {tuple(uk.shape)}")
    for name, numel in (("mw", 16 * k), ("t", k), ("dinv", 16)):
        v = qw[name]
        if v.dtype != torch.float32 or v.numel() != numel or not v.is_contiguous():
            raise ValueError(f"int8_wino: {name} must be {numel} contiguous float32 values")
    if any(v.device != dev for v in (uk, qw["mw"], qw["t"], qw["dinv"])):
        raise ValueError("int8_wino: every operand must be on x's device")
    if x_q.data_ptr() % 16 or uk.data_ptr() % 16:
        raise ValueError("int8_wino: x and the packed taps must be 16-byte aligned")


def _launch(x_q: torch.Tensor, qw: Dict, mode: str, leaky: bool) -> torch.Tensor:
    from yolo_tpu_torch.utils import kernels

    uk = qw["uk"] if "uk" in qw else pack_taps(qw["uq"])
    _check(x_q, qw, uk, mode)
    n, h, w, c = x_q.shape
    k = uk.shape[1]
    out = torch.empty((n, h, w, k), dtype=torch.int8, device=x_q.device)
    lib = kernels.load()
    with torch.cuda.device(x_q.device):
        code = lib.yolo_int8_wino(
            x_q.data_ptr(), uk.data_ptr(), qw["mw"].data_ptr(), qw["t"].data_ptr(),
            qw["dinv"].data_ptr(), out.data_ptr(), n, h, w, c, k, MODES[mode], int(leaky),
            torch.cuda.current_stream().cuda_stream)
    kernels.check(code, "yolo_int8_wino launch")
    LAUNCHES[mode] += 1
    return out


def conv3x3_wino(x_q: torch.Tensor, qc: Dict, leaky: bool = True) -> torch.Tensor:
    """3x3/s1/p1 int8 conv + requant by per-tap Winograd: (N, H, W, C) int8 ->
    (N, H, W, K) int8. ``qc["wino"]``: ``winograd.wino_quantize``'s dict
    (plus ``uk`` on the card). The kernel on CUDA tensors, the twin on CPU ones."""
    if x_q.device.type != "cuda":
        return conv3x3_wino_reference(x_q, qc, leaky)
    return _launch(x_q, qc["wino"], "full", leaky)


def wino_ablate(x_q: torch.Tensor, qw: Dict, mode: str) -> torch.Tensor:
    """The kernel in ablation ``mode`` with the leaky epilogue (module
    docstring); the twin on CPU tensors."""
    if mode not in MODES:
        raise ValueError(f"wino mode must be one of {sorted(MODES)}, got {mode!r}")
    if x_q.device.type != "cuda":
        return wino_ablate_reference(x_q, qw, mode)
    return _launch(x_q, qw, mode, leaky=True)


# ------------------------------------------------------------------ work
def work(n: int, h: int, w: int, c: int, k: int, mode: str = "full") -> Tuple[int, int, int]:
    """(int8 tensor operations, other operations, device-memory bytes) of one
    call: 2 operations per multiply-add of the 16 tap dots over the
    ceil(H/2) x ceil(W/2) tiles; the tap build's 32 integer adds and its 16
    multiplies and 16 roundings per tile and input channel; x, the packed
    taps (16, K, C), mw, t and dinv read once, the output written once."""
    th, tw = tiles(h, w)
    tiles_ = n * th * tw
    dots = 2 * 16 * tiles_ * c * k if mode != "taps" else 0
    taps = 64 * tiles_ * c if mode in ("full", "taps") else 0
    x_bytes = n * h * w * c if mode in ("full", "taps") else 0
    u_bytes = 16 * c * k + 4 * (16 * k + k + 16) if mode != "taps" else 4 * 16
    return dots, taps, x_bytes + u_bytes + n * h * w * k
