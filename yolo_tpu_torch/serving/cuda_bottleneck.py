"""Fused int8 bottleneck blocks through the CUDA kernels ``csrc/int8_bottleneck.cu``.

Port of the first half of yolo_tpu/serving/pallas_int8.py:

- :func:`block_int8` (JAX ``block_pallas``) runs one identity bottleneck in
  one launch of ``yolo_int8_bottleneck`` (TPU kernel
  ``_fused_identity_bottleneck_kernel``);
- :func:`chain_int8` (JAX ``chain_pallas``) runs a stage's stride-1
  bottlenecks, the first of which may carry a stride-1 downsample, in one
  launch of ``yolo_int8_chain`` (TPU kernel ``_chain_kernel``). It is the
  stage-chain hook of ``engine.int8_forward`` (``impl["layer1"..]``).

Both compute what ``engine._block`` computes with three (or four) int8 convs;
their plain twins, :func:`block_int8_reference` and
:func:`chain_int8_reference`, are ``engine._block`` with the float64 conv
(``engine.plain_conv``) chained, exact for these integer sums, so the kernels
equal them bit for bit. The JAX kernels' W padding to 32 columns and their
``real_w`` argument were a TPU sublane constraint; here a hook takes the
stage's image as it is.

On CPU tensors the wrappers run the twins. A CUDA tensor never reaches a
twin: the kernel runs or the call raises. The kernel takes C, P and the
chain's input channels in multiples of 64 (every full-width stage), int8
NHWC, 16-byte aligned; anything else raises.

Both kernels run ``csrc/sm90_bottleneck_tile.cuh``'s tile routine, which
the bf16 fused bottleneck (``experiments/fused_block_pallas.py``) shares;
:func:`plan` picks its output tile for all three.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from yolo_tpu_torch.serving import cuda_int8, engine
from yolo_tpu_torch.utils import kernels

#: Thread blocks the last launch kept resident (one an SM, each walking tiles).
LAST_GRID = 0

ALIGN = 64  # channel granularity of the kernels (K steps and column chunks)
MAX_CHAIN = 8  # bottlenecks in one chain launch
PTRS_PER_BLOCK = 13


# ------------------------------------------------------------------ twins
def block_int8_reference(x_q: torch.Tensor, qb: Dict) -> torch.Tensor:
    """One stride-1 bottleneck through ``engine._block`` with the float64 conv."""
    return engine._block(x_q, qb, 1, conv=engine.plain_conv)


def chain_int8_reference(x_q: torch.Tensor, qblocks: Sequence[Dict]) -> torch.Tensor:
    """The blocks of a chain, one after the other, through the twin."""
    for qb in qblocks:
        x_q = block_int8_reference(x_q, qb)
    return x_q


# ------------------------------------------------------------------ checks
def _dims(qblocks: Sequence[Dict], cin: int) -> Tuple[int, int]:
    """(C, P) of a chain; raises on blocks that do not chain as stride-1 bottlenecks."""
    if not 1 <= len(qblocks) <= MAX_CHAIN:
        raise ValueError(f"a chain holds 1 to {MAX_CHAIN} blocks, got {len(qblocks)}")
    p = qblocks[0]["conv1"]["wq"].shape[-1]
    c = qblocks[0]["conv3"]["wq"].shape[-1]
    for b, qb in enumerate(qblocks):
        want = {"conv1": (1, 1, cin if b == 0 else c, p), "conv2": (3, 3, p, p),
                "conv3": (1, 1, p, c)}
        if qb["downsample"] is not None:
            if b > 0:
                raise ValueError(f"block {b} of a chain carries a downsample; only the "
                                 f"first may")
            want["downsample"] = (1, 1, cin, c)
        elif b == 0 and cin != c:
            raise ValueError(f"an identity block needs Cin == C, got {cin} -> {c}")
        for name, shape in want.items():
            got = tuple(qb[name]["wq"].shape)
            if got != shape:
                raise ValueError(f"block {b} {name}: weight {got}, expected {shape}")
    return c, p


def _check(x: torch.Tensor, qblocks: Sequence[Dict]) -> Tuple[int, int]:
    """Shape checks on any device; on CUDA also what the kernel takes."""
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C) int8, got {x.dtype} {tuple(x.shape)}")
    c, p = _dims(qblocks, x.shape[3])
    if x.device.type == "cuda":
        check_kernel(x, c, p)
    return c, p


def check_kernel(x: torch.Tensor, c: int, p: int) -> None:
    """Raise unless the CUDA kernels take x (N, H, W, Cin) into C channels via P."""
    cin = x.shape[3]
    if cin % ALIGN or c % ALIGN or p % ALIGN:
        raise ValueError(f"the bottleneck kernels take Cin, C and P in multiples of {ALIGN}, "
                         f"got {cin}, {c}, {p}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    if min(x.shape[:3]) < 1:
        raise ValueError(f"x must not be empty, got {tuple(x.shape)}")


# ------------------------------------------------------------------ plan
#: Output tiles (TH, TW) plan() weighs: halo and tile rows of each fill 64-row
#: wgmma blocks with little padding (180 / 192 and 128 / 128 at 8 x 16 and
#: 16 x 8; 144 / 192 and 98 / 128 at 14 x 7; 100 / 128 and 64 / 64 at 8 x 8;
#: 81 / 128 and 49 / 64 at 7 x 7).
TILES = ((8, 16), (16, 8), (14, 7), (8, 8), (7, 7))
SMEM = 232448  # an H100's shared memory per block
MAX_ROW_BLOCKS = 4  # 64-row blocks of the halo or the tile (two items per warpgroup)
MIN_STAGES, MAX_STAGES = 3, 8
STAGE_K = 128  # bytes of K a ring stage holds
B_ROWS = 128  # weight rows a ring stage holds
SMS = 132  # an H100 SXM's SMs: one resident thread block each
# The cost model's rates, per SM and clock: 64 x 64 x 32 bytes of K per
# wgmma in 32 clocks at the card's dense rate (bf16 and int8 alike); bytes
# from L2 into shared memory; clocks of one epilogue of 64 x 64 outputs.
# A ring shallower than DEEP_RING stages costs RING_PENALTY a stage short
# (the chip run's forced tiles: at layer2 the 8 x 8 tile's 6 stages matched
# the 8 x 16 tile's 4 with a third more halo and weight traffic a pixel).
WGMMA_CLK, L2_BYTES_CLK, EPI_CLK = 32, 32, 200
DEEP_RING, RING_PENALTY = 5, 0.05


@dataclass(frozen=True)
class Plan:
    """One launch's tiling, as the kernels lay it out
    (``sm90_bottleneck_tile.cuh::make_tiling``)."""
    th: int
    tw: int
    tiles: int  # N * ceil(H / TH) * ceil(W / TW)
    m1_blocks: int  # 64-row blocks of the (TH + 2) x (TW + 2) halo
    m2_blocks: int  # 64-row blocks of the TH x TW tile
    stages: int  # depth of the weight / gather ring
    smem: int  # dynamic shared memory bytes


def _halves(cols: int, blocks: int) -> int:
    return 2 if cols % B_ROWS == 0 and blocks <= 2 else 1


def layout(n: int, h: int, w: int, cin: int, c: int, p: int, e: int, th: int,
           tw: int) -> Plan:
    """The kernels' layout of tile (th, tw) for x (n, h, w, cin) through P = p
    to C = c, e bytes an element; raises ValueError where they refuse it."""
    m1, m2 = (th + 2) * (tw + 2), th * tw
    m1b, m2b = -(-m1 // 64), -(-m2 // 64)
    if m1b > MAX_ROW_BLOCKS or m2b > MAX_ROW_BLOCKS:
        raise ValueError(f"tile {th}x{tw}: its halo ({m1}) or tile ({m2}) rows exceed "
                         f"{MAX_ROW_BLOCKS} blocks of 64")
    ldy = p * e + 16
    fixed = 1024 + m1 * ldy + m2b * 64 * ldy + m1b * 64 // 16 * 128 * 4
    stage = (m1b * 64 + B_ROWS) * STAGE_K
    if m2b * 64 * (64 * _halves(c, m2b) * e + 16) > stage:
        raise ValueError(f"tile {th}x{tw}: conv3's staging rows exceed a ring stage")
    stages = min(MAX_STAGES, (SMEM - fixed) // (stage + 16))
    if stages < MIN_STAGES:
        raise ValueError(f"tile {th}x{tw} at P = {p}: y1 and y2 leave shared memory for "
                         f"{stages} ring stages, fewer than {MIN_STAGES}")
    tiles = n * -(-h // th) * -(-w // tw)
    return Plan(th, tw, tiles, m1b, m2b, stages, fixed + stages * (stage + 16))


def cost(pl: Plan, cin: int, c: int, p: int, e: int, ds: bool = False, sms: int = SMS) -> float:
    """Clocks of one launch on ``sms`` SMs by the cost model: a tile takes
    the longer of its wgmmas and its bytes from L2 (every column block's
    weight rows, zero padding included, and the halo's x), plus its
    epilogues, more where the ring is shallow; each SM walks
    ceil(tiles / sms) tiles."""
    def product(cols, k_bytes, blocks, a_rows=0):
        nh = _halves(cols, blocks)
        chunks, ks = -(-cols // (64 * nh)), -(-k_bytes // STAGE_K)
        items = blocks * nh
        mma = chunks * ks * items * (STAGE_K // 32) * WGMMA_CLK
        l2 = chunks * ks * (64 * nh + a_rows) * STAGE_K
        return mma, l2, chunks * -(-items // 2) * EPI_CLK

    parts = [product(p, cin * e, pl.m1_blocks, pl.m1_blocks * 64),
             product(p, 9 * p * e, pl.m2_blocks), product(c, p * e, pl.m2_blocks)]
    if ds:
        parts.append(product(c, cin * e, pl.m2_blocks, pl.m2_blocks * 64))
    mma, l2, epi = (sum(v) for v in zip(*parts))
    shallow = 1 + RING_PENALTY * max(0, DEEP_RING - pl.stages)
    return -(-pl.tiles // sms) * (max(mma, l2 / L2_BYTES_CLK) + epi) * shallow


def plan(n: int, h: int, w: int, cin: int, c: int, p: int, e: int = 1, ds: bool = False,
         sms: int = SMS) -> Plan:
    """The tile of :data:`TILES` that the cost model times fastest for a
    bottleneck (chain) over x (n, h, w, cin) through P = p to C = c, e bytes
    an element (1: the int8 kernels, 2: the bf16 one); ``ds``: its first
    block carries the downsample. Ties go to the earlier tile."""
    best = None
    for th, tw in TILES:
        try:
            pl = layout(n, h, w, cin, c, p, e, th, tw)
        except ValueError:
            continue
        t = cost(pl, cin, c, p, e, ds, sms)
        if best is None or t < best[0]:
            best = (t, pl)
    if best is None:
        raise ValueError(f"no tile of {TILES} fits P = {p} in shared memory")
    return best[1]


# ------------------------------------------------------------------ launch
def _wk(qc: Dict) -> torch.Tensor:
    return qc["wk"] if "wk" in qc else cuda_int8.pack_weight(qc["wq"])


def _block_pointers(qb: Dict, dev, keep: List[torch.Tensor]) -> List[int]:
    """The 13 device pointers of one block, in the C interface's order."""
    convs = ["conv1", "conv2", "conv3"] + (["downsample"] if qb["downsample"] is not None else [])
    wk = {name: _wk(qb[name]) for name in convs}
    r = qb["rx"] if qb["downsample"] is None else qb["ds_rescale"]
    floats = [qb[name][k] for name in convs for k in ("m", "t")] + [r]
    for name, v in wk.items():
        k = qb[name]["wq"][..., 0].numel()
        if v.dtype != torch.int8 or tuple(v.shape) != (qb[name]["wq"].shape[-1], k):
            raise ValueError(f"{name}: packed weight must be ({qb[name]['wq'].shape[-1]}, {k}) "
                             f"int8, got {v.dtype} {tuple(v.shape)}")
    for v in [*wk.values(), *floats]:
        if v.device != dev or not v.is_contiguous():
            raise ValueError("every q-param of a block must be contiguous and on x's device")
    if any(v.dtype != torch.float32 for v in floats) or r.numel() != 1:
        raise ValueError("m, t, rx and ds_rescale must be float32 (rx one value)")
    keep += [*wk.values(), *floats]
    ptrs = [wk["conv1"].data_ptr(), wk["conv2"].data_ptr(), wk["conv3"].data_ptr()]
    ptrs += [v.data_ptr() for v in floats[:6]] + [r.data_ptr()]
    if "downsample" in wk:
        ptrs += [wk["downsample"].data_ptr(), floats[6].data_ptr(), floats[7].data_ptr()]
    return ptrs + [None] * (PTRS_PER_BLOCK - len(ptrs))


def _pointer_array(qblocks: Sequence[Dict], dev, keep: List[torch.Tensor]):
    ptrs = []
    for qb in qblocks:
        ptrs += _block_pointers(qb, dev, keep)
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def block_int8(x_q: torch.Tensor, qb: Dict,
               tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One identity bottleneck: (N, H, W, C) int8 -> (N, H, W, C) int8.

    The kernel ``yolo_int8_bottleneck`` on CUDA tensors, on :func:`plan`'s
    tile unless ``tile`` (TH, TW) is given; :func:`block_int8_reference` on
    CPU tensors.
    """
    if qb["downsample"] is not None:
        raise ValueError("block_int8 runs identity blocks; a downsample block is a chain's "
                         "first block (chain_int8) or engine._block")
    c, p = _check(x_q, [qb])
    if x_q.device.type != "cuda":
        return block_int8_reference(x_q, qb)
    global LAST_GRID
    n, h, w, _ = x_q.shape
    pl = plan(n, h, w, c, c, p) if tile is None else layout(n, h, w, c, c, p, 1, *tile)
    keep: List[torch.Tensor] = []
    ptrs = _pointer_array([qb], x_q.device, keep)
    out = torch.empty_like(x_q)
    grid = ctypes.c_int(0)
    kernels.launch("yolo_int8_bottleneck", x_q.device, x_q.data_ptr(), out.data_ptr(), ptrs, n,
                   h, w, c, p, pl.th, pl.tw, ctypes.byref(grid))
    LAST_GRID = grid.value
    return out


def chain_int8(x_q: torch.Tensor, qblocks: Sequence[Dict],
               tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """A stage's stride-1 bottlenecks: (N, H, W, Cin) int8 -> (N, H, W, C) int8.

    The first block may carry a stride-1 downsample (layer1's block 0). One
    launch of ``yolo_int8_chain`` on CUDA tensors, on :func:`plan`'s tile
    unless ``tile`` (TH, TW) is given; :func:`chain_int8_reference` on CPU
    tensors.
    """
    c, p = _check(x_q, qblocks)
    if x_q.device.type != "cuda":
        return chain_int8_reference(x_q, qblocks)
    global LAST_GRID
    n, h, w, cin = x_q.shape
    ds = qblocks[0]["downsample"] is not None
    pl = plan(n, h, w, cin, c, p, ds=ds) if tile is None else layout(n, h, w, cin, c, p, 1,
                                                                       *tile)
    keep: List[torch.Tensor] = []
    ptrs = _pointer_array(qblocks, x_q.device, keep)
    out = torch.empty((n, h, w, c), dtype=torch.int8, device=x_q.device)
    tmp = torch.empty_like(out) if len(qblocks) > 1 else None
    barrier = torch.empty(1, dtype=torch.int32, device=x_q.device)
    grid = ctypes.c_int(0)
    kernels.launch("yolo_int8_chain", x_q.device, x_q.data_ptr(), out.data_ptr(),
                   None if tmp is None else tmp.data_ptr(), barrier.data_ptr(), ptrs,
                   len(qblocks), n, h, w, cin, c, p, pl.th, pl.tw, ctypes.byref(grid))
    LAST_GRID = grid.value
    return out


# ------------------------------------------------------------------ work
def work(n: int, h: int, w: int, cin: int, c: int, p: int, nb: int,
         ds: bool) -> Tuple[int, int]:
    """(int8 operations, device-memory bytes) of a chain of ``nb`` blocks
    (a single block: nb = 1): 2 ops per multiply-add of the useful convs;
    the input read once, the output written once, every weight and
    per-channel constant read once."""
    px = n * h * w
    macs = px * (cin * p + 9 * p * p + p * c) + (nb - 1) * px * (c * p + 9 * p * p + p * c)
    weights = cin * p + 9 * p * p + p * c + (nb - 1) * (c * p + 9 * p * p + p * c)
    consts = nb * 4 * (2 * p + 2 * p + 2 * c + 1)
    if ds:
        macs += px * cin * c
        weights += cin * c
        consts += 4 * 2 * c
    return 2 * macs, px * cin + px * c + weights + consts
