"""The CUDA kernels (NMS and the four fused-BN kernels) against their plain twins, on the card.

Marked ``cuda``: these tests need an NVIDIA GPU and nvcc, and skip without
them. Run them on the GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda.py``; ``chip_smoke.py``
covers the same ground at the slices' shapes.
"""

import numpy as np
import pytest
import torch

from yolo_tpu_torch.ops import cuda_nms
from yolo_tpu_torch.ops.decode import Detections

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _random(seed, n, K, ties):
    r = np.random.default_rng(seed)
    boxes = r.uniform(0.1, 0.9, size=(n, K, 4)).astype(np.float32)
    boxes[..., 2:] *= 0.5
    scores = r.uniform(size=(n, K)).astype(np.float32)
    if ties:
        boxes = boxes[:, r.integers(0, min(4, K), size=K)]
        scores = np.round(scores * 2) / 2
    cls = r.integers(0, 3, size=(n, K)).astype(np.int32)
    valid = r.uniform(size=(n, K)) < 0.7
    valid[0] = False
    return Detections(*(torch.from_numpy(np.ascontiguousarray(a))
                        for a in (boxes, scores, cls, valid)))


@pytest.mark.parametrize("K", [1, 31, 98, 162, 392, 1024])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("eps", [1e-6, 0.0])
def test_kernel_equals_plain_twin(device, K, ties, eps):
    cpu = _random(K, 37, K, ties)
    ref = cuda_nms.nms(cpu, 0.45, eps=eps).valid
    before = cuda_nms.LAUNCHES
    got = cuda_nms.nms(Detections(*(t.to(device) for t in cpu)), 0.45, eps=eps).valid
    torch.cuda.synchronize()
    assert cuda_nms.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), ref)


def test_kernel_rejects_too_many_candidates(device):
    dets = Detections(*(t.to(device) for t in _random(0, 2, 1025, False)))
    with pytest.raises(ValueError):
        cuda_nms.nms(dets)


# ------------------------------------------------------------ fused BN
# Tolerances, in the working dtype (kernel vs plain twin on the same card):
# sums are taken in another order and nvcc contracts x*mul+add into an FMA,
# so float32 results agree to a few ulps of the operands' magnitude
# (rtol 1e-5, atol 1e-5 * max|ref|), and a bfloat16 result may round to the
# neighbouring value (one bf16 ulp: rtol 2**-7, atol 2**-7 * max|ref|).
def _tol(dtype):
    return (1e-5, 1e-5) if dtype == torch.float32 else (2.0**-7, 2.0**-7)


def _close(got, ref, dtype):
    rtol, atol = _tol(dtype)
    got, ref = got.float().cpu(), ref.float().cpu()
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol * float(ref.abs().max()) + 1e-30)


def _bn_inputs(seed, shape, dtype, device):
    r = np.random.default_rng(seed)
    n, c, h, w = shape
    make = lambda: torch.from_numpy(r.normal(size=(n, h, w, c)).astype(np.float32)).permute(
        0, 3, 1, 2).to(device=device, dtype=dtype)  # channels_last views
    vec = lambda lo, hi: torch.from_numpy(r.uniform(lo, hi, c).astype(np.float32)).to(device)
    return make(), make(), make(), vec(0.5, 1.5), vec(-0.2, 0.2), vec(0.5, 2.0)


BN_SHAPES = [(2, 64, 9, 7), (4, 256, 6, 6), (1, 72, 5, 3), (2, 2048, 2, 2)]


@pytest.mark.parametrize("shape", BN_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("res", [False, True])
def test_fused_bn_kernels_equal_plain_twins(device, shape, dtype, relu, res):
    from yolo_tpu_torch.ops import fused_bn as fb

    x, rr, g, mul, add, r = _bn_inputs(sum(shape), shape, dtype, device)
    assert x.is_contiguous(memory_format=torch.channels_last)
    residual = rr if res else None
    before = dict(fb.LAUNCHES)
    relayouts = fb.RELAYOUTS
    mean, var = fb.bn_stats(x)
    out = fb.bn_normalize(x, mul, add, residual, relu)
    s1, s2 = fb.bn_bwd_reduce(g, out, x, mean, r, relu)
    dx, dres = fb.bn_bwd_dx(g, out, x, mul, add, r, relu, res)
    torch.cuda.synchronize()
    assert all(fb.LAUNCHES[k] == before[k] + 1 for k in before)
    assert fb.RELAYOUTS == relayouts
    assert out.is_contiguous(memory_format=torch.channels_last)

    cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
    rm, rv = fb.bn_stats_reference(cpu(x))
    _close(mean, rm, torch.float32)
    _close(var, rv, torch.float32)
    _close(out, fb.bn_normalize_reference(cpu(x), cpu(mul), cpu(add), cpu(residual), relu), dtype)
    # The backward is checked on the kernel's own forward output, so the
    # ReLU masks are the same bits on both sides.
    r1, r2 = fb.bn_bwd_reduce_reference(cpu(g), cpu(out), cpu(x), cpu(mean), cpu(r), relu)
    _close(s1, r1, torch.float32)
    _close(s2, r2, torch.float32)
    rdx, rdres = fb.bn_bwd_dx_reference(cpu(g), cpu(out), cpu(x), cpu(mul), cpu(add), cpu(r),
                                        relu, res)
    _close(dx, rdx, dtype)
    if res:
        assert torch.equal(dres.cpu(), rdres)
    else:
        assert dres is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_bn_reductions_are_deterministic(device, dtype):
    from yolo_tpu_torch.ops import fused_bn as fb

    x, _, g, _, _, r = _bn_inputs(5, (8, 128, 28, 28), dtype, device)
    runs = [fb.bn_stats(x) + fb.bn_bwd_reduce(g, x, x, x.float().mean((0, 2, 3)), r, True)
            for _ in range(3)]
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))


def test_fused_bn_relayouts_a_gradient_in_another_layout(device):
    from yolo_tpu_torch.ops import fused_bn as fb

    x, _, g, mul, add, r = _bn_inputs(9, (2, 64, 4, 4), torch.float32, device)
    before = fb.RELAYOUTS
    got = fb.bn_bwd_dx(g.contiguous(), x, x, mul, add, r, True, False)[0]
    assert fb.RELAYOUTS == before + 1  # g arrives in NCHW; out (= x) is channels_last
    ref = fb.bn_bwd_dx(g, x, x, mul, add, r, True, False)[0]
    assert torch.equal(got, ref)


def test_fused_bn_rejects_what_the_kernels_do_not_take(device):
    from yolo_tpu_torch.ops import fused_bn as fb

    x = torch.zeros((2, 6, 3, 3), device=device).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        fb.bn_stats(x)  # C % 4 != 0
    with pytest.raises(TypeError):
        fb.bn_stats(torch.zeros((2, 8, 3, 3), device=device, dtype=torch.float16))


def test_fused_bn_act_grads_equal_unfused_autograd(device):
    """The "full" autograd Function on the card against torch autograd through
    the plain recipe on the CPU, float32. The closed-form backward and the
    autograd chain round differently (sums of M products that cancel), so
    this holds to 1e-4 of the largest gradient, not to the twins' 1e-5."""
    from yolo_tpu_torch.ops import fused_bn as fb

    x, rr, g, w, b, _ = _bn_inputs(11, (4, 256, 7, 7), torch.float32, device)
    args = [t.clone().requires_grad_() for t in (x, w, b, rr)]
    out, _, _ = fb.fused_bn_act(*args, True)
    (out * g).sum().backward()
    ref_args = [t.detach().cpu().requires_grad_() for t in (x, w, b, rr)]
    mean, var = fb.bn_stats_reference(ref_args[0])
    mul = torch.rsqrt(var + fb.EPS) * ref_args[1]
    ref = fb.bn_normalize_reference(ref_args[0], mul, ref_args[2] - mean * mul, ref_args[3], True)
    (ref * g.cpu()).sum().backward()
    _close(out.detach(), ref.detach(), torch.float32)
    for name, a, ra in zip(("dx", "dscale", "dbias", "dres"), args, ref_args):
        torch.testing.assert_close(a.grad.cpu(), ra.grad, rtol=1e-4,
                                   atol=1e-4 * float(ra.grad.abs().max()), msg=name)
