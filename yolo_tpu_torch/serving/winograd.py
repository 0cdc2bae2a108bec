"""Per-tap int8 Winograd F(2x2, 3x3) convs of the serving engine (``wino=``).

Port of yolo_tpu/serving/winograd.py, with the same names and the same
numbers. F(2,3) computes each 2x2 output tile from a 4x4 input tile with 16
multiplies instead of 36:

- the input taps ``V = Bᵀ d B`` are exact int32 sums of int8 activations;
- each tap ``t`` is requantized to int8 with its own calibrated scale
  (``dinv``), since the 16 taps' ranges differ by up to 4x;
- the weight taps ``U = G w Gᵀ`` come from the folded float32 weights,
  quantized per (tap, output channel) (``uq``, ``mw``);
- 16 int8 dots (M tiles, C) x (C, K), then the float32 inverse transform
  and the bias / activation / requant epilogue of the direct conv.

It is not bit-exact against the direct conv (the tap requant rounds), but
the kernel ``csrc/int8_wino.cu`` (``serving/cuda_wino.py``) and its twin
:func:`conv3x3_wino_rq` compute the same numbers in the same order, and the
twin equals the JAX package's XLA and Pallas paths bit for bit:

1. ``V_t`` in int32, on the input zero-padded by 1; odd H or W get zeros at
   the bottom / right up to ``2*ceil(max(H, W)/2) + 2`` and the surplus
   output row / column is cropped;
2. ``vq_t = clip(rint(f32(V_t) * dinv_t), -127, 127)``;
3. ``acc_t = vq_t . U_t``, exact (the twin sums in float64);
4. ``m_t = f32(acc_t) * mw[t, k]``;
5. ``Y_p = sum_t A2[p, t] m_t`` in float32, ascending t from the first
   nonzero term (the Pallas kernel's order);
6. ``q(act(Y_p + t))``, leaky for the head convs and ReLU for the
   backbone's conv2s, scattered to ``(2i + r, 2j + s)``.

``wino_quantize`` builds U as two explicit float32 contractions (over the
kernel's rows, then its columns, each in ascending order), which equals
JAX's einsum bit for bit; every division takes a 0-dim tensor on the
weights' device, as in ``serving/quant.py``.
"""

from __future__ import annotations

import re
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# F(2x2, 3x3) transform matrices (Lavin & Gray 2016), as in the JAX package.
B_T = np.array(
    [[1, 0, -1, 0],
     [0, 1, 1, 0],
     [0, -1, 1, 0],
     [0, 1, 0, -1]], dtype=np.float32)
G = np.array(
    [[1.0, 0.0, 0.0],
     [0.5, 0.5, 0.5],
     [0.5, -0.5, 0.5],
     [0.0, 0.0, 1.0]], dtype=np.float32)
A_T = np.array(
    [[1, 1, 1, 0],
     [0, 1, -1, -1]], dtype=np.float32)
#: Inverse transform Y[p] = sum_t A2[p, t] M[t], A2 = A_T (x) A_T, p = 2r + s, t = 4a + b.
A2 = np.einsum("ra,sb->rsab", A_T, A_T).reshape(4, 16)

HEAD_POINTS = ("head_conv1", "head_conv3", "head_conv4")
_BLOCK_POINT = re.compile(r"l([1-4])b(\d+)_conv2$")


# ------------------------------------------------------------------ points
def valid_points(stage_sizes: Sequence[int]) -> Tuple[str, ...]:
    """Every conv a ``wino`` name may select: the stride-1 3x3 conv2s (every
    block of layer1, blocks >= 1 of layers 2-4) and head convs 1, 3 and 4."""
    names = [f"l{s + 1}b{b}_conv2" for s, n in enumerate(stage_sizes)
             for b in range(n) if s == 0 or b > 0]
    return tuple(names) + HEAD_POINTS


def check_points(wino: Sequence[str], stage_sizes: Optional[Sequence[int]] = None) -> None:
    """Raise ValueError for a name that is not a stride-1 3x3 conv.

    With ``stage_sizes`` the names must exist in that backbone; without,
    they must have the form of one (``l{s}b{b}_conv2``, b >= 1 past layer1,
    or ``head_conv1/3/4``)."""
    if stage_sizes is not None:
        valid = valid_points(stage_sizes)
        bad = [n for n in wino if n not in valid]
        listing = ", ".join(valid)
    else:
        def ok(name):
            m = _BLOCK_POINT.match(name)
            return name in HEAD_POINTS or (m is not None and (m[1] == "1" or m[2] != "0"))
        bad = [n for n in wino if not ok(n)]
        listing = "l1b{b}_conv2, l{2-4}b{b >= 1}_conv2, " + ", ".join(HEAD_POINTS)
    if bad:
        raise ValueError(f"wino: {bad} are not stride-1 3x3 convs; valid names: {listing}")


def wino_points_of(q: Dict) -> Tuple[str, ...]:
    """Conv names carrying per-tap Winograd params in an engine q-dict, so an
    artifact loader re-installs the same hooks (no silent direct conv)."""
    names = []
    for si, blocks in enumerate(q.get("layers", ())):
        for bi, qb in enumerate(blocks):
            if "wino" in qb.get("conv2", {}):
                names.append(f"l{si + 1}b{bi}_conv2")
    for i in range(1, 5):
        if "wino" in q.get("head", {}).get(f"conv{i}", {}):
            names.append(f"head_conv{i}")
    return tuple(names)


# ------------------------------------------------------------------ taps
def _tile_slices(xp: torch.Tensor, n_tiles: int) -> List[torch.Tensor]:
    """(N, 2T+2, 2T+2, C) padded input -> 16 views (N, T, T, C):
    view[4u + v][n, i, j, c] = xp[n, 2i + u, 2j + v, c]."""
    n, hp, wp, c = xp.shape
    x5 = xp.reshape(n, hp // 2, 2, wp // 2, 2, c)
    views = []
    for u in range(4):
        du, pu = divmod(u, 2)
        for v in range(4):
            dv, pv = divmod(v, 2)
            views.append(x5[:, du:du + n_tiles, pu, dv:dv + n_tiles, pv, :])
    return views


def _padded(x: torch.Tensor, n_tiles: int, dtype) -> torch.Tensor:
    """x (N, H, W, C) in a (N, 2T+2, 2T+2, C) zero frame at offset (1, 1)."""
    n, h, w, c = x.shape
    xp = torch.zeros((n, 2 * n_tiles + 2, 2 * n_tiles + 2, c), dtype=dtype, device=x.device)
    xp[:, 1:h + 1, 1:w + 1, :] = x
    return xp


def _signed_sum(terms, coefs):
    """sum of +-term over the nonzero coefficients, in order."""
    acc = None
    for term, c in zip(terms, coefs):
        if c == 0:
            continue
        term = term if c > 0 else -term
        acc = term if acc is None else acc + term
    return acc


def _taps(views: List[torch.Tensor]) -> List[torch.Tensor]:
    """The 16 taps Bᵀ d B (t = 4a + b) from the 16 tile-element views."""
    taps = []
    for a in range(4):
        rows = [_signed_sum([views[u * 4 + v] for u in range(4)], B_T[a]) for v in range(4)]
        for b in range(4):
            taps.append(_signed_sum(rows, B_T[b]))
    return taps


def input_taps_i32(x_q: torch.Tensor, n_tiles: int) -> List[torch.Tensor]:
    """int8 (N, H, W, C) activations -> 16 exact int32 taps, each (N, T, T, C)."""
    return _taps(_tile_slices(_padded(x_q, n_tiles, torch.int32), n_tiles))


def tap_maxima(x: torch.Tensor) -> torch.Tensor:
    """(16,) max |Bᵀ x B| of a float activation batch, NHWC (a permuted view
    of an NCHW tensor is fine), padded as the conv pads it. Real units."""
    n_tiles = (max(x.shape[1], x.shape[2]) + 1) // 2
    taps = _taps(_tile_slices(_padded(x.float(), n_tiles, torch.float32), n_tiles))
    return torch.stack([t.abs().amax() for t in taps])


# ------------------------------------------------------------------ params
def weight_taps(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, C, K) -> U (16, C, K) = G w Gᵀ, in float32, summed over the
    kernel's rows, then its columns, each in ascending order."""
    w = w.float()
    t1 = [[_sum([float(G[a, i]) * w[i, j] for i in range(3)]) for j in range(3)]
          for a in range(4)]
    u = [_sum([float(G[b, j]) * t1[a][j] for j in range(3)]) for a in range(4) for b in range(4)]
    return torch.stack(u)


def _sum(terms):
    acc = terms[0]
    for term in terms[1:]:
        acc = acc + term
    return acc


def wino_quantize(w, b, s_in: float, s_out: float, tap_max_real) -> Dict:
    """Folded float32 conv params -> the Winograd conv's int8 params.

    ``tap_max_real``: (16,) calibrated max |Bᵀ x B| in real units. Returns
    {"uq" (16, C, K) int8, "mw" (16, 1, K) f32, "t" (K,) f32, "dinv" (16, 1, 1) f32}.
    """
    from yolo_tpu_torch.serving.quant import _f32

    dev = w.device
    u = weight_taps(w)
    su = torch.clamp(u.abs().amax(dim=1, keepdim=True) / _f32(127.0, dev), min=1e-12)
    uq = torch.round(u / su).clamp(-127, 127).to(torch.int8)
    if not isinstance(tap_max_real, torch.Tensor):
        tap_max_real = torch.from_numpy(np.array(tap_max_real, np.float32))
    tm = tap_max_real.to(device=dev, dtype=torch.float32)
    d = torch.clamp(tm / _f32(s_in, dev), min=1.0) / _f32(127.0, dev)
    mw = d[:, None, None] * su * _f32(s_in, dev) / _f32(s_out, dev)
    return {"uq": uq, "mw": mw, "t": b.float() / _f32(s_out, dev),
            "dinv": (_f32(1.0, dev) / d)[:, None, None]}


# ------------------------------------------------------------------ the twin
def tap_requant(x_q: torch.Tensor, dinv: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """Steps 1-2: (16, N*T*T, C) int8 taps of x_q."""
    n, c = x_q.shape[0], x_q.shape[3]
    v = torch.stack([t.reshape(n * n_tiles * n_tiles, c)
                     for t in input_taps_i32(x_q, n_tiles)])
    return torch.round(v.float() * dinv.reshape(16, 1, 1)).clamp(-127, 127).to(torch.int8)


def inverse(m: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Step 5: the 4 outputs Y_p from the 16 dequantized taps m_t."""
    return [_signed_sum(m, A2[p]) for p in range(4)]


def activate(y: torch.Tensor, leaky: bool) -> torch.Tensor:
    """Step 6 after the bias: leaky or ReLU, then round and clip to int8."""
    y = torch.where(y > 0, y, 0.1 * y) if leaky else torch.clamp(y, min=0.0)
    return torch.round(y).clamp(-127, 127).to(torch.int8)


def scatter(y: Sequence[torch.Tensor], n: int, n_tiles: int, h: int, w: int) -> torch.Tensor:
    """4 per-position (N*T*T, K) results -> (N, H, W, K), the surplus cropped."""
    k = y[0].shape[-1]
    out = torch.stack(list(y)).reshape(2, 2, n, n_tiles, n_tiles, k)
    out = out.permute(2, 3, 0, 4, 1, 5).reshape(n, 2 * n_tiles, 2 * n_tiles, k)
    return out[:, :h, :w, :].contiguous()


def conv3x3_wino_rq(x_q: torch.Tensor, qc: Dict, leaky: bool = True) -> torch.Tensor:
    """3x3/s1/p1 int8 conv + requant via per-tap int8 Winograd F(2,3), in
    plain torch (the kernel's twin). ``qc["wino"]``: :func:`wino_quantize`'s
    dict. Any N, H, W; any device."""
    qw = qc["wino"]
    n, h, w, _ = x_q.shape
    n_tiles = (max(h, w) + 1) // 2
    vq = tap_requant(x_q, qw["dinv"], n_tiles)
    # 16 exact int8 dots: every partial sum is an integer below 2**53.
    acc = torch.bmm(vq.double(), qw["uq"].double())
    mw = qw["mw"].reshape(16, 1, -1)
    m = [acc[t].float() * mw[t] for t in range(16)]
    return scatter([activate(y + qw["t"], leaky) for y in inverse(m)], n, n_tiles, h, w)


# ------------------------------------------------------------------ hooks
def conv3x3_wino_auto(x_q: torch.Tensor, qc: Dict, leaky: bool = True) -> torch.Tensor:
    """The Winograd conv: the kernel ``csrc/int8_wino.cu`` on CUDA tensors at
    any H and W, :func:`conv3x3_wino_rq` on CPU tensors."""
    from yolo_tpu_torch.serving import cuda_wino

    return cuda_wino.conv3x3_wino(x_q, qc, leaky)


def wino_impl_hooks(wino: Sequence[str], impl: Optional[Dict] = None, conv=None) -> Dict:
    """Engine ``impl`` hooks for the named Winograd convs: the head convs with
    the leaky epilogue, the backbone's conv2s with ReLU. ``conv`` is the
    conv they call (:func:`conv3x3_wino_auto`; :func:`conv3x3_wino_rq` runs
    the twin on any device, for checks)."""
    check_points(wino)
    conv = conv or conv3x3_wino_auto
    impl = dict(impl or {})
    for name in wino:
        if name.startswith("head_conv"):
            impl[name] = partial(conv, leaky=True)
        else:
            s1 = dict(impl.get("conv2_s1", {}))
            s1[name.removesuffix("_conv2")] = partial(conv, leaky=False)
            impl["conv2_s1"] = s1
    return impl
