"""Layer constructors with the reference's torch arithmetic, and seeded init.

Port of yolo_tpu/models/layers.py. Torch is the reference's own framework,
so most of what the JAX file emulates is native here: symmetric conv
padding, LeakyReLU(0.1), max pooling that pads with -inf, and BatchNorm with
eps 1e-5 and momentum 0.1. What stays is PyTorch's default initialisation
(uniform +-1/sqrt(fan_in) for conv and linear weights and biases), drawn from
an explicit ``torch.Generator`` so that a seed fixes the weights.

The port's own modules: :class:`FusedBatchNormAct`, the train-mode
BN(+residual)+ReLU through the CUDA kernels of ``ops/fused_bn.py`` (JAX
``FusedBatchNormAct``, layers.py:178-265); :class:`BatchNorm2d`, torch's
BatchNorm; :class:`Dropout`, whose mask comes from its own
``torch.Generator`` (or is handed to it), not from the global RNG; and
:class:`Int8Conv2d`, the dynamic-int8 conv (JAX ``_Int8ConvCore``,
layers.py:88-139) on the int8 conv kernel ``csrc/int8_conv.cu``.

Recomputation (``remat``, ``models/backbones.py``) re-runs a train-mode
forward for the backward pass. Both BN modules update their running
statistics in place, so they skip the update while :func:`recomputing` is
true: the statistics move once a step, as flax writes ``batch_stats`` once.
:func:`checkpoint` is ``torch.utils.checkpoint.checkpoint`` with that flag
set in its recompute context.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.nn.utils import skip_init

from yolo_tpu_torch.ops import fused_bn
from yolo_tpu_torch.utils import tracing

LEAKY_SLOPE = 0.1

_RECOMPUTING = contextvars.ContextVar("yolo_tpu_torch_recomputing", default=False)


def recomputing() -> bool:
    """True inside a forward that :func:`checkpoint` re-runs for the backward pass."""
    return _RECOMPUTING.get()


@contextlib.contextmanager
def _recompute_context():
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


def checkpoint(fn, *args):
    """``fn(*args)`` whose activations are recomputed in the backward pass.

    Non-reentrant ``torch.utils.checkpoint`` (the counterpart of flax's
    ``nn.remat``). The recomputed forward runs with :func:`recomputing`
    true, so BN leaves its running statistics alone there. The RNG state is
    not restored: the checkpointed blocks draw no random numbers.
    """
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _recompute_context()))


def conv(
    cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0,
    bias: bool = True, *, device: torch.device | str, quantized: bool = False,
) -> nn.Conv2d:
    """Conv2d with symmetric padding, parameters left for :func:`init_weights_`;
    ``quantized`` makes it an :class:`Int8Conv2d` (the same parameters)."""
    return skip_init(
        Int8Conv2d if quantized else nn.Conv2d, cin, cout, kernel, stride=stride,
        padding=padding, bias=bias, device=device,
    )


def linear(fin: int, fout: int, *, device: torch.device | str) -> nn.Linear:
    return skip_init(nn.Linear, fin, fout, device=device)


def batch_norm(c: int, *, device: torch.device | str) -> nn.BatchNorm2d:
    return skip_init(BatchNorm2d, c, eps=1e-5, momentum=0.1, device=device)


def _update_running_stats(bn: nn.BatchNorm2d, mean, var, count) -> None:
    """torch's running-stat update: momentum, the unbiased ``var*M/(M-1)``
    (ROADMAP F1), ``num_batches_tracked += 1``; none in a recomputed forward."""
    if recomputing():
        return
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var.detach() * (count / (count - 1)), alpha=m)
        bn.num_batches_tracked.add_(1)


def _global_count(x: torch.Tensor, group) -> int:
    """Rows of the global batch: every rank of ``group`` holds as many as ``x``."""
    import torch.distributed as dist

    return x.numel() // x.shape[1] * dist.get_world_size(group)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that leaves its running statistics alone in a
    recomputed forward (:func:`recomputing`), and synchronizes its
    statistics under data parallelism.

    In a recomputed forward it normalizes with the batch statistics as
    before, into copies of the running buffers that are thrown away, so
    torch takes the same kernel path and computes the same values as in the
    first forward. With ``sync_group`` set (``parallel.sync_batch_norm``, a
    data axis of several ranks) train mode is the synchronized ``"full"``
    path of ``ops.fused_bn`` without ReLU: the kernels on the card, their
    twins on the CPU. JAX's unfused BN under a mesh is XLA's over the
    global batch, and ``torch.nn.SyncBatchNorm`` refuses CPU tensors.
    """

    sync_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.sync_group is not None:
            out, mean, var = fused_bn.fused_bn_act(x, self.weight, self.bias, None, False,
                                                   self.sync_group)
            _update_running_stats(self, mean, var, _global_count(x, self.sync_group))
            return out
        if self.training and recomputing():
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                self.weight, self.bias, True, self.momentum, self.eps)
        return super().forward(x)


def leaky_relu() -> nn.LeakyReLU:
    """LeakyReLU with the reference's 0.1 negative slope."""
    return nn.LeakyReLU(LEAKY_SLOPE, inplace=True)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """PyTorch's default init for every conv/linear/BN under ``module``.

    Conv and linear: weight and bias uniform in +-1/sqrt(fan_in), which is
    ``kaiming_uniform_(a=sqrt(5))`` and the JAX package's
    ``torch_kernel_init``. BatchNorm: weight 1, bias 0, running mean 0,
    running var 1. Draws come from ``generator``, in module order.
    """
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
    return module


class FusedBatchNormAct(nn.BatchNorm2d):
    """BatchNorm(+residual)+ReLU whose train mode runs the fused-BN kernels.

    An ``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1) with exactly its
    parameters and buffers, so state dicts interchange with the unfused
    model and with a reference ``.pth``: ``fused_bn`` switches the kernels,
    not the model. ``forward(x, residual=None)`` returns
    ``relu?(bn(x) + residual)``.

    Train mode, ``mode="full"``: statistics, normalize and both backward
    passes run through the kernels (``ops.fused_bn.fused_bn_act``).
    ``mode="stats"``: only the statistics do; normalize and the backward are
    torch, as in JAX. The running statistics are torch's: momentum 0.1, the
    **unbiased** batch variance ``var*M/(M-1)`` (flax uses the biased one;
    ROADMAP F1), ``num_batches_tracked += 1``. Eval mode is plain torch in
    JAX's op order, ``((x - mean) * (rsqrt(var + eps) * weight) + bias)``.

    With ``sync_group`` set (``parallel.sync_batch_norm``, a data axis of
    several ranks) train mode is the synchronized ``"full"`` path whatever
    ``mode`` says, and the running variance takes the global ``M``; at
    ``n_data == 1`` ``mode`` keeps its meaning.
    """

    sync_group = None

    def __init__(self, c: int, relu: bool = True, mode: str = "full", *,
                 device: torch.device | str | None = None):
        if mode not in ("stats", "full"):
            raise ValueError(f"mode must be 'stats' or 'full', got {mode!r}")
        super().__init__(c, eps=1e-5, momentum=0.1, device=device)
        self.relu, self.mode = relu, mode

    def extra_repr(self) -> str:
        return f"{super().extra_repr()}, relu={self.relu}, mode={self.mode!r}"

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None) -> torch.Tensor:
        count = x.numel() // x.shape[1]
        if self.training and self.sync_group is not None:
            out, mean, var = fused_bn.fused_bn_act(x, self.weight, self.bias, residual,
                                                   self.relu, self.sync_group)
            count = _global_count(x, self.sync_group)
        elif self.training and self.mode == "full":
            out, mean, var = fused_bn.fused_bn_act(x, self.weight, self.bias, residual,
                                                   self.relu)
        else:
            if self.training:
                mean, var = fused_bn.bn_stats_diff(x)
            else:
                mean, var = self.running_mean, self.running_var
            shape = (1, -1, 1, 1)
            mul = torch.rsqrt(var + self.eps) * self.weight
            y = ((x.float() - mean.reshape(shape)) * mul.reshape(shape)
                 + self.bias.reshape(shape)).to(x.dtype)
            if residual is not None:
                y = y + residual
            out = torch.relu(y) if self.relu else y
        if self.training:
            _update_running_stats(self, mean, var, count)
        return out


class Dropout(nn.Module):
    """Dropout whose mask comes from an explicit generator (flax's arithmetic).

    Train mode keeps each element with probability ``1 - p`` and scales the
    kept ones by ``1 / (1 - p)`` (``flax.linen.Dropout``); eval mode is the
    identity. The mask is drawn from ``generator``, a ``torch.Generator``
    created on the input's device and seeded with ``seed`` at first use
    (:meth:`manual_seed` re-seeds it). A test can set ``fixed_mask`` (a bool
    tensor of the input's shape, True = keep) to use that mask instead.

    ``shard`` = (data coordinate, n_data, model coordinate, n_model), set by
    ``parallel.shard_head``: the input is this rank's block of a global
    ``(N * n_data, F * n_model)`` activation. The global mask is drawn (every
    rank's generator is seeded alike) and the rank keeps its rows and
    columns, so a seed gives the same mask on any mesh, as in JAX;
    ``fixed_mask`` is then the global mask, cut the same way.
    """

    def __init__(self, p: float = 0.5, seed: int = 0):
        super().__init__()
        self.p, self.seed = p, seed
        self.generator: torch.Generator | None = None
        self.fixed_mask: torch.Tensor | None = None
        self.shard: tuple | None = None

    def extra_repr(self) -> str:
        return f"p={self.p}, seed={self.seed}"

    def manual_seed(self, seed: int) -> None:
        self.seed, self.generator = seed, None

    def generator_on(self, device: torch.device) -> torch.Generator:
        """The mask generator on ``device``, made from ``seed`` at first use."""
        if self.generator is None or self.generator.device != torch.device(device):
            self.generator = torch.Generator(device=device).manual_seed(self.seed)
        return self.generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = self.fixed_mask
        shape = x.shape
        if self.shard is not None:
            d, n_data, m, n_model = self.shard
            shape = (x.shape[0] * n_data, x.shape[1] * n_model)
        if mask is None:
            mask = torch.rand(shape, generator=self.generator_on(x.device),
                              device=x.device) < keep
        if self.shard is not None:
            n, f = x.shape
            mask = mask[d * n:(d + 1) * n, m * f:(m + 1) * f]
        return torch.where(mask.to(x.device), x / keep, torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))


class Int8Conv2d(nn.Conv2d):
    """Dynamic-int8 conv for inference (JAX ``_Int8ConvCore``, layers.py:88-139).

    An ``nn.Conv2d`` with the same ``weight`` and ``bias``, so float32
    state dicts load as they are. Each call computes, in JAX's op order:

    - per output channel ``s_w = max(max|W| / 127, 1e-8)`` and
      ``w_q = clip(round(W / s_w), -127, 127)`` (cached while the weight
      is unchanged, with its packed form for the kernel);
    - one per-tensor ``s_x = max(max|x| / 127, 1e-8)`` over the whole batch
      and ``x_q = clip(round(x / s_x), -127, 127)``;
    - the int8 conv of ``x_q`` and ``w_q`` with an int32 accumulator, and
      ``y = float(acc) * (s_x * s_w) + bias`` (+0 without a bias).

    The conv and its epilogue are one call of ``serving.cuda_int8.conv_int8``
    in mode ``"float"``: the kernel ``csrc/int8_conv.cu`` on CUDA tensors,
    its plain twin ``conv_int8_reference`` on CPU tensors. The scales stay
    on the device; every division is by a 0-dim device tensor, which torch
    computes as a true division (a host scalar becomes a multiply by its
    reciprocal on CUDA). Activations go NCHW -> NHWC and back as views where
    ``x`` is channels_last. Inference only: a train-mode forward raises.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Imported here: the serving package's __init__ loads the HTTP server.
        from yolo_tpu_torch.serving import cuda_int8

        if self.training:
            raise RuntimeError("Int8Conv2d is inference only (quantized=True); call .eval()")
        wq, s_w, wk, c127 = self.quantized_weight()
        with tracing.span("int8conv.quantize"):
            xq, s_x = quantize_input(x, c127)
        t = self.bias if self.bias is not None else torch.zeros_like(s_w)
        y = cuda_int8.conv_int8(xq, wq, s_x * s_w, t, self.stride[0], self.padding[0],
                                "float", wk=wk)
        return y.permute(0, 3, 1, 2).to(x.dtype)

    @torch.no_grad()
    def quantized_weight(self):
        """(w_q HWIO int8, s_w (Cout,) float32, the kernel's packed w_q or
        None on the CPU, the 0-dim float32 127 on the weight's device)."""
        from yolo_tpu_torch.serving import cuda_int8

        w = self.weight
        key = (w.data_ptr(), w._version, w.device, w.dtype)
        cache = getattr(self, "_int8_cache", None)
        if cache is None or cache[0] != key:
            c127 = torch.full((), 127.0, dtype=torch.float32, device=w.device)
            wf = w.float()
            s_w = torch.clamp(wf.abs().amax(dim=(1, 2, 3)) / c127, min=1e-8)
            wq = torch.round(wf / s_w.reshape(-1, 1, 1, 1)).clamp(-127, 127).to(torch.int8)
            wq = wq.permute(2, 3, 1, 0).contiguous()
            wk = cuda_int8.pack_weight(wq) if w.device.type == "cuda" else None
            cache = (key, (wq, s_w, wk, c127))
            self._int8_cache = cache
        return cache[1]


def quantize_input(x: torch.Tensor, c127: torch.Tensor):
    """(x_q NHWC int8 contiguous, s_x 0-dim float32) of NCHW ``x``, one
    per-tensor scale over the batch (JAX ``_Int8ConvCore``'s order)."""
    xh = x.permute(0, 2, 3, 1).float()
    s_x = torch.clamp(xh.abs().amax() / c127, min=1e-8)
    xq = torch.round(xh / s_x).clamp(-127, 127).to(torch.int8)
    return xq.contiguous(), s_x
