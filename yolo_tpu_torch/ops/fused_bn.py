"""Train-mode BatchNorm(+residual)+ReLU through the CUDA kernels ``csrc/fused_bn.cu``.

Port of yolo_tpu/ops/fused_bn.py. Four kernels, each with a plain torch twin
of the same arithmetic:

- :func:`bn_stats` (TPU ``bn_stats`` -> ``_stats_kernel``): per-channel mean
  and biased variance in float32, ``var = max(0, E[x^2] - E[x]^2)``;
- :func:`bn_normalize` (``_norm_kernel`` / ``_norm_res_kernel``):
  ``relu?(x*mul + add (+ residual))``; with a residual the normalized value
  is rounded to x's dtype before the add;
- :func:`bn_bwd_reduce` (``_bwd_reduce_kernel``): ``(sum gz, sum gz*xhat)``
  with ``gz = g*(out > 0)`` under ReLU and ``xhat = x*r - mean*r``;
- :func:`bn_bwd_dx` (``_bwd_dx_kernel`` / ``_bwd_dx_res_kernel``):
  ``dx = A*gz - (B*x - D)``, and ``dres = gz``.

A CUDA tensor launches the kernel or the call raises; a CPU tensor takes
the twin. On the card an activation is a channels_last 4-D tensor (or a
contiguous 2-D (M, C) one): an operand in another layout, as a gradient can
arrive in ``backward``, is copied once into channels_last and counted in
:data:`RELAYOUTS`. ``kernels.LAUNCHES`` counts the launches by C entry point.

:func:`fused_bn_act` (the ``"full"`` mode) differentiates through
``bn_bwd_reduce`` and ``bn_bwd_dx``; :func:`bn_stats_diff` (the ``"stats"``
mode) through a plain torch backward, as JAX's jnp custom VJP does. The
per-channel arithmetic between the kernels stays torch on C-length vectors.

Synchronized statistics (``fused_bn_act(..., group=)``, data parallelism):
the stats kernel's local (mean, var) become sums, ``count*mean`` and
``count*(var + mean^2)``, which are all-reduced with the counts over
``group`` before the normalize kernel, so the global ``var = E[x^2] -
E[x]^2`` is JAX's recipe over the global batch; in the backward pass
``(sum gz, sum gz*xhat)`` are all-reduced between bwd_reduce and bwd_dx,
and the global count enters bwd_dx's coefficients. The weight and bias
gradients stay this rank's sums (DistributedDataParallel averages them).
:data:`ALL_REDUCES` counts these all-reduces. ``group=None``, or a group
of one rank, issues no collective.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from yolo_tpu_torch.utils import kernels

EPS = 1e-5

#: Operands copied into channels_last before a launch.
RELAYOUTS = 0
#: All-reduces of synchronized statistics (forward and backward) since last set to 0.
ALL_REDUCES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS, _MAX_TX, _TARGET_BLOCKS = 256, 32, 1024


# ------------------------------------------------------------------ twins
def _per_channel(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (C,) vector shaped to broadcast over ``like``'s channel dim 1."""
    return v.reshape(1, -1, *([1] * (like.dim() - 2)))


def _reduce_dims(t: torch.Tensor) -> list:
    return [d for d in range(t.dim()) if d != 1]


def bn_stats_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, biased var) in float32 over every dim but 1."""
    xf = x.float()
    count = x.numel() // x.shape[1]
    dims = _reduce_dims(x)
    mean = xf.sum(dims) / count
    var = ((xf * xf).sum(dims) / count - mean * mean).clamp(min=0.0)
    return mean, var


def bn_normalize_reference(x, mul, add, residual=None, relu=True) -> torch.Tensor:
    y = x.float() * _per_channel(mul, x) + _per_channel(add, x)
    if residual is not None:
        y = (y.to(x.dtype) + residual).float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _masked_grad(g, out, relu) -> torch.Tensor:
    gz = g.float()
    return torch.where(out.float() > 0, gz, 0.0) if relu else gz


def bn_bwd_reduce_reference(g, out, x, mean, r, relu) -> Tuple[torch.Tensor, torch.Tensor]:
    gz = _masked_grad(g, out, relu)
    xh = x.float() * _per_channel(r, x) + _per_channel(-mean * r, x)
    dims = _reduce_dims(x)
    return gz.sum(dims), (gz * xh).sum(dims)


def bn_bwd_dx_reference(g, out, x, a, b, d, relu, want_dres):
    gz = _masked_grad(g, out, relu)
    bx = x.float() * _per_channel(b, x) + _per_channel(-d, x)
    dx = (_per_channel(a, x) * gz - bx).to(g.dtype)
    return dx, (gz.to(g.dtype) if want_dres else None)


# ---------------------------------------------------------------- kernels
def _rows_cols(t: torch.Tensor) -> Tuple[int, int]:
    c = t.shape[1]
    return t.numel() // c, c


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it: channels_last 4-D or contiguous 2-D."""
    global RELAYOUTS
    if t.dim() == 4:
        if t.is_contiguous(memory_format=torch.channels_last):
            return t
        RELAYOUTS += 1
        return t.contiguous(memory_format=torch.channels_last)
    if t.dim() == 2:
        if t.is_contiguous():
            return t
        RELAYOUTS += 1
        return t.contiguous()
    raise ValueError(f"fused_bn: expected a 4-D or 2-D activation, got {t.dim()}-D")


def _check(x: torch.Tensor, *others: Optional[torch.Tensor]) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_bn: activations must be float32 or bfloat16, got {x.dtype}")
    vec = 16 // x.element_size()
    m, c = _rows_cols(x)
    if c % vec or m < 1:
        raise ValueError(f"fused_bn: the kernels take C % {vec} == 0 and M >= 1, got "
                         f"M={m}, C={c}")
    for t in others:
        if t is None:
            continue
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"fused_bn: operand {tuple(t.shape)} {t.dtype} on {t.device} "
                             f"does not match x {tuple(x.shape)} {x.dtype} on {x.device}")
    for t in (x, *others):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("fused_bn: the kernels need 16-byte aligned tensors")


def row_groups(m: int, c: int, element_size: int) -> int:
    """The kernels' G: row groups per channel tile (grid.y, workspace rows)."""
    cv = c // (16 // element_size)
    tx = min(cv, _MAX_TX)
    ty = _THREADS // tx
    tiles = -(-cv // tx)
    return max(1, min(-(-m // ty), -(-_TARGET_BLOCKS // tiles), 65535))


def _scalars(*rows: torch.Tensor) -> torch.Tensor:
    return torch.stack([r.float() for r in rows]).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = _kernel_layout(x)
    _check(x)
    m, c = _rows_cols(x)
    g = row_groups(m, c, x.element_size())
    ws = torch.empty((g, 2, c), dtype=torch.float32, device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    kernels.launch("yolo_bn_stats", x.device, x.data_ptr(), ws.data_ptr(), out.data_ptr(),
                   m, c, g, _DTYPES[x.dtype])
    return out[0], out[1]


def _launch_normalize(x, mul, add, residual, relu) -> torch.Tensor:
    x = _kernel_layout(x)
    residual = None if residual is None else _kernel_layout(residual)
    _check(x, residual)
    m, c = _rows_cols(x)
    y = torch.empty_like(x)
    scal = _scalars(mul, add)
    kernels.launch("yolo_bn_normalize", x.device, x.data_ptr(), _ptr(residual),
                   scal.data_ptr(), y.data_ptr(), m, c, row_groups(m, c, x.element_size()),
                   _DTYPES[x.dtype], int(relu))
    return y


def _launch_bwd_reduce(g, out, x, mean, r, relu):
    x, g = _kernel_layout(x), _kernel_layout(g)
    out = _kernel_layout(out) if relu else None
    _check(x, g, out)
    m, c = _rows_cols(x)
    groups = row_groups(m, c, x.element_size())
    scal = _scalars(r, -mean * r)
    ws = torch.empty((groups, 2, c), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
    kernels.launch("yolo_bn_bwd_reduce", x.device, g.data_ptr(), _ptr(out), x.data_ptr(),
                   scal.data_ptr(), ws.data_ptr(), sums.data_ptr(), m, c, groups,
                   _DTYPES[x.dtype], int(relu))
    return sums[0], sums[1]


def _launch_bwd_dx(g, out, x, a, b, d, relu, want_dres):
    x, g = _kernel_layout(x), _kernel_layout(g)
    out = _kernel_layout(out) if relu else None
    _check(x, g, out)
    m, c = _rows_cols(x)
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if want_dres else None
    scal = _scalars(a, b, -d)
    kernels.launch("yolo_bn_bwd_dx", x.device, g.data_ptr(), _ptr(out), x.data_ptr(),
                   scal.data_ptr(), dx.data_ptr(), _ptr(dres), m, c,
                   row_groups(m, c, x.element_size()), _DTYPES[x.dtype], int(relu))
    return dx, dres


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"fused_bn: unsupported device {x.device}")


def bn_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased var) float32 per channel (dim 1) of ``x``."""
    return _launch_stats(x) if _on_cuda(x) else bn_stats_reference(x)


def bn_normalize(x, mul, add, residual=None, relu=True) -> torch.Tensor:
    """``relu?(x*mul + add (+ residual))`` in x's dtype; mul/add (C,) float32."""
    if _on_cuda(x):
        return _launch_normalize(x, mul, add, residual, relu)
    return bn_normalize_reference(x, mul, add, residual, relu)


def bn_bwd_reduce(g, out, x, mean, r, relu):
    """(sum gz, sum gz*xhat) float32 per channel; ``r = rsqrt(var + eps)``."""
    if _on_cuda(x):
        return _launch_bwd_reduce(g, out, x, mean, r, relu)
    return bn_bwd_reduce_reference(g, out, x, mean, r, relu)


def bn_bwd_dx(g, out, x, a, b, d, relu, want_dres):
    """(dx, dres or None) in g's dtype: ``dx = a*gz - (b*x - d)``, ``dres = gz``."""
    if _on_cuda(x):
        return _launch_bwd_dx(g, out, x, a, b, d, relu, want_dres)
    return bn_bwd_dx_reference(g, out, x, a, b, d, relu, want_dres)


# ------------------------------------------------------- autograd Functions
def _synchronized(group) -> bool:
    if group is None:
        return False
    import torch.distributed as dist

    return dist.get_world_size(group) > 1


def _all_reduce(buf: torch.Tensor, group) -> torch.Tensor:
    global ALL_REDUCES
    import torch.distributed as dist

    dist.all_reduce(buf, group=group)
    ALL_REDUCES += 1
    return buf


def _global_stats(mean, var, count: int, group):
    """(mean, biased var, count) over ``group`` from this rank's, as float32
    sums of ``(count, count*mean, count*(var + mean^2))``."""
    c = mean.numel()
    buf = torch.cat([mean.new_full((1,), float(count)), count * mean,
                     count * (var + mean * mean)])
    buf = _all_reduce(buf, group)
    total = buf[0]
    g_mean = buf[1:c + 1] / total
    return g_mean, (buf[c + 1:] / total - g_mean * g_mean).clamp(min=0.0), total


class _BNAct(torch.autograd.Function):
    """BN(+residual)+ReLU forward and backward through the kernels (``"full"``).

    Forward and backward as fused_bn.py:378-402, with the statistics and the
    backward's sums all-reduced over ``group`` where it has several ranks.
    The batch mean and var are outputs for the running-stat update and
    carry no gradient.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, residual, relu, group):
        mean, var = bn_stats(x)
        count = x.numel() // x.shape[1]
        if _synchronized(group):
            mean, var, count = _global_stats(mean, var, count, group)
        r = torch.rsqrt(var + EPS)
        mul = r * weight
        out = bn_normalize(x, mul, bias - mean * mul, residual, relu)
        # Without ReLU the backward needs no output (a following in-place op may change it).
        ctx.save_for_backward(x, out if relu else None, mean, r, weight)
        ctx.relu, ctx.has_res, ctx.group, ctx.count = relu, residual is not None, group, count
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g_out, _g_mean, _g_var):
        x, out, mean, r, weight = ctx.saved_tensors
        dbias, dscale = bn_bwd_reduce(g_out, out, x, mean, r, ctx.relu)
        sum_gz, sum_gzx = dbias, dscale
        if _synchronized(ctx.group):
            sum_gz, sum_gzx = _all_reduce(torch.stack([dbias, dscale]), ctx.group).unbind(0)
        count = ctx.count
        mul = r * weight
        # dx = mul*(gz - sum(gz)/M - xhat*sum(gz*xhat)/M) = A*gz - B*x + D
        b = mul * r * sum_gzx / count
        d = mean * b - mul * sum_gz / count
        dx, dres = bn_bwd_dx(g_out, out, x, mul, b, d, ctx.relu, ctx.has_res)
        return dx, dscale, dbias, dres, None, None


def fused_bn_act(x, weight, bias, residual=None, relu=True, group=None):
    """Train-mode BN(+residual)+ReLU of ``x``; returns (out, batch mean, batch var).

    With ``group`` (a process group of several ranks) the batch is the
    union of every rank's ``x``, and the mean and var are the global ones.
    """
    return _BNAct.apply(x, weight, bias, residual, relu, group)


class _BNStats(torch.autograd.Function):
    """Batch statistics through the ``stats`` kernel, with a plain backward.

    d/dx of (mean, var) is a per-channel affine of x (fused_bn.py:358-365):
    ``dx = (dmean - 2*mean*dvar)/M + x*(2*dvar/M)``.
    """

    @staticmethod
    def forward(ctx, x):
        mean, var = bn_stats(x)
        ctx.save_for_backward(x, mean)
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, mean = ctx.saved_tensors
        count = x.numel() // x.shape[1]
        g_mean = torch.zeros_like(mean) if g_mean is None else g_mean
        g_var = torch.zeros_like(mean) if g_var is None else g_var
        base = (g_mean - 2.0 * mean * g_var) / count
        slope = 2.0 * g_var / count
        return (_per_channel(base, x) + x.float() * _per_channel(slope, x)).to(x.dtype)


def bn_stats_diff(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (mean, var) of ``x`` through the ``stats`` kernel."""
    return _BNStats.apply(x)


def bytes_moved(kernel: str, m: int, c: int, element_size: int, *, relu: bool = True,
                residual: bool = False) -> int:
    """Device-memory bytes one launch reads and writes (activations only)."""
    passes = {
        "stats": 1,
        "normalize": 2 + residual,
        "bwd_reduce": 2 + relu,
        "bwd_dx": 3 + relu + residual,
    }[kernel]
    return passes * m * c * element_size

