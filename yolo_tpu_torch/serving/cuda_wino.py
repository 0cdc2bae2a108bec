"""Per-tap int8 Winograd F(2,3) conv through the CUDA kernels of ``csrc/int8_wino.cu``.

Port of the TPU kernel yolo_tpu/serving/pallas_wino.py::_wino_kernel (entry
``_wino_conv``, public ``conv3x3_wino_pallas``), and of its ablation
variants in experiments/wino_ablate.py::kernel_variant as the ``mode``:

- ``"full"``: the conv, :func:`conv3x3_wino` (tap build, per-tap requant,
  16 int8 tap dots, dequant, inverse transform, bias, leaky or ReLU, int8);
- ``"taps"``: the tap build and requant only; output (2i + r, 2j + s, k) is
  tap ``p = 2r + s`` of tile (i, j) at channel k (needs K <= C);
- ``"dots"``: the tap dots, dequant, inverse and epilogue on all-zero
  taps, so every output is ``q(act(t_k))``;
- ``"dots-raw"``: the 16 dots on zero taps; the epilogue runs on the raw
  accumulators of taps 12-15 (no dequant, no inverse), ``q(act(0 + t_k))``.

On the H100 a conv is two kernels, as the TPU kernel builds its taps into
a scratch and then runs one dot a tap: the tap pass reads x once and writes
the requantized taps to a (16, Mt, C) int8 scratch (Mt = N * ceil(H/2) *
ceil(W/2) tiles, allocated here with ``torch.empty``), and the tap GEMM
runs the 16 tap dots on the shared wgmma mainloop
(``csrc/sm90_conv_core.cuh``) with the dequant and the inverse transform
after each tap and the requant at the end (the old single kernel rebuilt
the taps in every 64-channel column block and ran ``mma.sync``). The
wide convs are bound by the int8 tensor cores, layer1 by device memory,
where the scratch costs 4x x's bytes written and read again.
:func:`plan` picks the GEMM's tile by shape. ``"taps"`` is the tap pass
alone, ``"dots"`` and ``"dots-raw"`` the GEMM alone on all-zero taps (made
by :func:`zero_taps`; the caller may pass them in, so that their zero-fill
is not part of a timed call). ``kernels.LAUNCHES`` counts the two C entry
points apart; :data:`ENTRIES` names those each mode calls once.

Its twins are :func:`conv3x3_wino_reference` (``winograd.conv3x3_wino_rq``)
and :func:`wino_ablate_reference`; the kernels equal them bit for bit. On
CPU tensors the wrappers run the twins. A CUDA tensor never reaches a twin:
the kernels run or the call raises. They take int8 NHWC activations at any
N, H and W (odd and non-square included), C and K in multiples of 64,
16-byte aligned, and the weight taps packed K-major per tap, ``uk`` (16, K,
C) (:func:`pack_taps`; ``engine.to_device`` stores it beside ``uq``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from yolo_tpu_torch.serving import winograd
from yolo_tpu_torch.utils import kernels

MODES = {"full": 0, "taps": 1, "dots": 2, "dots-raw": 3}
#: The C entry points each mode calls once: the tap pass, the tap GEMM or both.
ENTRIES = {"full": ("yolo_int8_wino_taps", "yolo_int8_wino_gemm"),
           "taps": ("yolo_int8_wino_taps",), "dots": ("yolo_int8_wino_gemm",),
           "dots-raw": ("yolo_int8_wino_gemm",)}
ALIGN = 64  # channel granularity of the kernels (C stages and K column blocks)
#: The tap GEMM's tiles (tile rows, output channels): 128-row tiles run two
#: consumer warpgroups a block, 64-row tiles one.
TILES = ((128, 64), (64, 64))
_SMS = 132  # streaming multiprocessors of an H100 SXM


def pack_taps(uq: torch.Tensor) -> torch.Tensor:
    """U (16, C, K) int8 -> (16, K, C) int8, C contiguous (the kernel's B operand)."""
    return uq.permute(0, 2, 1).contiguous()


def tiles(h: int, w: int) -> Tuple[int, int]:
    """The kernel's 2x2 output tiles a side (rows, columns)."""
    return (h + 1) // 2, (w + 1) // 2


def scratch_shape(n: int, h: int, w: int, c: int) -> Tuple[int, int, int]:
    """The tap pass's output: (16, Mt, C) int8, Mt = N * ceil(H/2) * ceil(W/2)."""
    th, tw = tiles(h, w)
    return 16, n * th * tw, c


@functools.lru_cache(maxsize=None)
def plan(n: int, h: int, w: int, c: int, k: int) -> int:
    """The tap GEMM's tile by shape, an index into :data:`TILES`: 128-row
    tiles (two consumer warpgroups) unless they would give fewer units than
    half the SMs (layer4 and head_conv3 at batch 16, every conv at batch
    1-2), then 64-row tiles, one consumer warpgroup, twice the units."""
    mt = scratch_shape(n, h, w, c)[1]
    return 0 if -(-mt // TILES[0][0]) * (k // ALIGN) >= _SMS // 2 else 1


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
    if any(v.data_ptr() % 16 for v in (x_q, uk, qw["mw"], qw["t"])):
        raise ValueError("int8_wino: x, the packed taps, mw and t must be 16-byte aligned")
    _, mt, _ = scratch_shape(n, h, w, c)
    if mt * c >= 2**31:
        raise ValueError(f"int8_wino: a tap of the scratch, {mt} x {c}, must stay under 2 GB")


# tap_pass and tap_gemm take operands that _check has passed; chip_smoke.py
# times them one by one.
def tap_pass(x_q: torch.Tensor, dinv: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Steps 1-2 (``winograd.tap_requant``): the (16, Mt, C) int8 taps, or
    with ``out`` ((N, H, W, K) int8) the ``"taps"`` mode's output there."""
    n, h, w, c = x_q.shape
    dst = torch.empty(scratch_shape(n, h, w, c), dtype=torch.int8,
                      device=x_q.device) if out is None else out
    kernels.launch("yolo_int8_wino_taps", x_q.device, x_q.data_ptr(), dinv.data_ptr(),
                   dst.data_ptr(), n, h, w, c, dst.shape[-1], int(out is not None))
    return dst


def tap_gemm(vq: torch.Tensor, qw: Dict, uk: torch.Tensor, shape: Tuple[int, int, int],
             leaky: bool, raw: bool = False) -> torch.Tensor:
    """Steps 3-6 on the (16, Mt, C) taps ``vq`` of an (N, H, W) image batch:
    the (N, H, W, K) int8 output (``raw``: the dots-raw epilogue), with
    :func:`plan`'s tile."""
    n, h, w = shape
    _, k, c = uk.shape
    out = torch.empty((n, h, w, k), dtype=torch.int8, device=vq.device)
    kernels.launch("yolo_int8_wino_gemm", vq.device, vq.data_ptr(), uk.data_ptr(),
                   qw["mw"].data_ptr(), qw["t"].data_ptr(), out.data_ptr(), n, h, w, c, k,
                   plan(n, h, w, c, k), int(raw), int(leaky))
    return out


def zero_taps(x_q: torch.Tensor) -> torch.Tensor:
    """All-zero (16, Mt, C) int8 taps for x's shape, on x's device: the
    dots modes' A operand."""
    return torch.zeros(scratch_shape(*x_q.shape), dtype=torch.int8, device=x_q.device)


def _launch(x_q: torch.Tensor, qw: Dict, mode: str, leaky: bool,
            zeros: Optional[torch.Tensor] = None) -> torch.Tensor:
    uk = qw["uk"] if "uk" in qw else pack_taps(qw["uq"])
    _check(x_q, qw, uk, mode)
    n, h, w, c = x_q.shape
    k = uk.shape[1]
    if mode == "taps":
        return tap_pass(x_q, qw["dinv"], torch.empty((n, h, w, k), dtype=torch.int8,
                                                     device=x_q.device))
    if mode == "full":
        vq = tap_pass(x_q, qw["dinv"])
    elif zeros is None:
        vq = zero_taps(x_q)
    elif (zeros.dtype != torch.int8 or tuple(zeros.shape) != scratch_shape(n, h, w, c)
          or zeros.device != x_q.device or not zeros.is_contiguous() or zeros.data_ptr() % 16):
        raise ValueError(f"int8_wino: zero taps must be contiguous 16-byte aligned "
                         f"{scratch_shape(n, h, w, c)} int8 on x's device")
    else:
        vq = zeros
    return tap_gemm(vq, qw, uk, (n, h, w), leaky, raw=mode == "dots-raw")


def conv3x3_wino(x_q: torch.Tensor, qc: Dict, leaky: bool = True) -> torch.Tensor:
    """3x3/s1/p1 int8 conv + requant by per-tap Winograd: (N, H, W, C) int8 ->
    (N, H, W, K) int8. ``qc["wino"]``: ``winograd.wino_quantize``'s dict
    (plus ``uk`` on the card). The kernel on CUDA tensors, the twin on CPU ones."""
    if x_q.device.type != "cuda":
        return conv3x3_wino_reference(x_q, qc, leaky)
    return _launch(x_q, qc["wino"], "full", leaky)


def wino_ablate(x_q: torch.Tensor, qw: Dict, mode: str,
                zeros: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel in ablation ``mode`` with the leaky epilogue (module
    docstring); the twin on CPU tensors. ``zeros``: the dots modes' all-zero
    taps (:func:`zero_taps`), made here when not given."""
    if mode not in MODES:
        raise ValueError(f"wino mode must be one of {sorted(MODES)}, got {mode!r}")
    if x_q.device.type != "cuda":
        return wino_ablate_reference(x_q, qw, mode)
    return _launch(x_q, qw, mode, leaky=True, zeros=zeros)


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
