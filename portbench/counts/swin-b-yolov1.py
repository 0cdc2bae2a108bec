"""Layers of ``swin-b-yolov1`` as training runs them, counted from shapes.

:func:`ops_per_image` gives one image's forward in bf16 (the training
forward runs under autocast): the patch-embedding conv, each block's qkv,
proj, fc1 and fc2 and its two attention products over the padded map, the
merges' reductions, the head's four convs and two FCs (2 operations a
multiply-add; LayerNorm, GELU, softmax and the window machinery are not
counted). :func:`window_attention` gives each block's attention core at a
batch, forward and backward: its operations and the bytes it has to move,
each input read once and each output written once. :func:`attention_least_seconds`
is the least time of one step's attention on the chip.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

from portbench.counts.conv import Conv
from portbench.counts.peaks import HBM_BYTES_PER_S, PEAK

BF16, F32 = 2, 4


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


class Stage(NamedTuple):
    """A stage's map (h, w), its map padded to the window (hp, wp), channels,
    heads and blocks."""

    h: int
    w: int
    hp: int
    wp: int
    c: int
    heads: int
    depth: int


def stages(cfg) -> List[Stage]:
    ws = cfg["window_size"]
    h = w = _ceil(cfg["image_size"], cfg["patch_size"])
    out = []
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        out.append(Stage(h, w, _ceil(h, ws) * ws, _ceil(w, ws) * ws,
                         cfg["embed_dim"] * 2 ** i, heads, depth))
        h, w = _ceil(h, 2), _ceil(w, 2)
    return out


def head_convs(cfg) -> List[Conv]:
    last = stages(cfg)[-1]
    h, cin, hc = last.h, last.c, cfg["head_channels"]
    out = []
    for i in range(4):
        s = 2 if i == 1 else 1
        out.append(Conv(f"head.conv{i + 1}", h, h, cin, hc, 3, s, 1, "leaky"))
        h, cin = (h + 2 - 3) // s + 1, hc
    out.append(Conv("head.fc1", 1, 1, cin * h * h, cfg["fc_hidden"], 1, 1, 0, "float"))
    return out


def block_macs(cfg, st: Stage) -> Dict[str, int]:
    """Multiply-adds of one block of stage ``st`` on one image."""
    t, n, c = st.hp * st.wp, cfg["window_size"] ** 2, st.c
    hidden = int(c * cfg["mlp_ratio"])
    return {"qkv": t * c * 3 * c, "attention": 2 * t * n * c, "proj": t * c * c,
            "mlp": 2 * st.h * st.w * c * hidden}


def ops_per_image(cfg, engine: str) -> Dict[str, int]:
    """Operations of one image's training forward, all in bf16 (autocast)."""
    if engine != "train":
        raise ValueError(f"swin-b-yolov1 runs no {engine!r} engine")
    p = cfg["patch_size"]
    sts = stages(cfg)
    macs = sts[0].h * sts[0].w * sts[0].c * 3 * p * p
    for i, st in enumerate(sts):
        macs += st.depth * sum(block_macs(cfg, st).values())
        if i < len(sts) - 1:
            macs += _ceil(st.h, 2) * _ceil(st.w, 2) * 4 * st.c * 2 * st.c
    macs += sum(c.macs() for c in head_convs(cfg))
    macs += cfg["fc_hidden"] * cfg["S"] ** 2 * (cfg["B"] * 5 + cfg["num_classes"])
    return {"bf16": 2 * macs}


class Work(NamedTuple):
    """One block's attention core at a batch: operations and bytes, forward and backward."""

    stage: int
    ops_fwd: int
    bytes_fwd: int
    ops_bwd: int
    bytes_bwd: int


def window_attention(cfg, batch: int) -> List[Work]:
    """Every block's attention core, ``softmax(q k^T * scale + mask) v`` over
    its windows, at ``batch`` images. Tokens ``t`` (padded), channels ``c``,
    window ``n`` tokens, the additive mask of (nW * heads, n, n) in bf16.

    Forward: 2 products, ``4 t n c`` operations; reads q, k, v and the mask,
    writes the output (bf16) and the float32 log-sum-exp a token and head.
    Backward: 5 products (S again, dV, dP, dQ, dK), ``10 t n c``; reads q, k,
    v, the output, its gradient, the log-sum-exp and the mask, writes dq,
    dk, dv and the mask's gradient once (summed over the batch)."""
    n = cfg["window_size"] ** 2
    out = []
    for i, st in enumerate(stages(cfg)):
        t = batch * st.hp * st.wp
        act = t * st.c * BF16
        lse = t * st.heads * F32
        mask = st.hp * st.wp // n * st.heads * n * n * BF16
        work = Work(i, 4 * t * n * st.c, 4 * act + lse + mask,
                    10 * t * n * st.c, 8 * act + lse + 2 * mask)
        out += [work] * st.depth
    return out


def attention_least_seconds(cfg, batch: int) -> float:
    """The least time of one training step's attention cores: per block and
    pass the larger of operations over the bf16 peak and bytes over the
    HBM's rate, summed."""
    peak = PEAK["bf16"]
    return sum(max(w.ops_fwd / peak, w.bytes_fwd / HBM_BYTES_PER_S)
               + max(w.ops_bwd / peak, w.bytes_bwd / HBM_BYTES_PER_S)
               for w in window_attention(cfg, batch))
