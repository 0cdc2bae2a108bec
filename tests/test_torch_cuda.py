"""The CUDA kernels (NMS, the four fused-BN kernels, the int8 stem front, the
int8 max-pool after the stem, the int8 conv, the fused int8 bottleneck and stage chain, the per-tap int8
Winograd conv (tap pass + tap GEMM) with its ablation modes, and the
kernels of the ported experiments/ harnesses: the fused Adam update, the
int8 dot + requant (the int8 conv's kernel on a 1x1 view), the bf16 3x3
conv + BN statistics and the bf16 fused bottleneck) against their plain
twins, on the card; and the serving engines replayed from captured CUDA
graphs (serving/graphs.py) against their eager calls.

Marked ``cuda``: these tests need an NVIDIA GPU and nvcc, and skip without
them. Run them on the GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda.py``; ``chip_smoke.py``
covers the same ground at the slices' shapes.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from yolo_tpu_torch.experiments import bf16_ulp
from yolo_tpu_torch.ops import cuda_nms
from yolo_tpu_torch.ops.decode import Detections
from yolo_tpu_torch.utils import kernels

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
    before = kernels.LAUNCHES["yolo_nms"]
    got = cuda_nms.nms(Detections(*(t.to(device) for t in cpu)), 0.45, eps=eps).valid
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["yolo_nms"] == before + 1
    assert torch.equal(got.cpu(), ref)


def _float64(cpu):
    return cpu._replace(boxes=cpu.boxes.double(), scores=cpu.scores.double())


@pytest.mark.parametrize("K", [1, 98, 392, 1024])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("eps", [1e-6, 0.0])
def test_float64_kernel_equals_plain_twin(device, K, ties, eps):
    """The precise evaluator's instantiation: float64 boxes and scores, the
    threshold and eps as float64 (0.4 is not float32's 0.4)."""
    cpu = _float64(_random(K + 1, 37, K, ties))
    ref = cuda_nms.nms(cpu, 0.4, eps=eps).valid
    before = kernels.LAUNCHES["yolo_nms_f64"]
    got = cuda_nms.nms(Detections(*(t.to(device) for t in cpu)), 0.4, eps=eps).valid
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["yolo_nms_f64"] == before + 1
    assert torch.equal(got.cpu(), ref)


def test_float64_kernel_single_class_k1024_and_threshold(device):
    """The float64 kernel's largest shared memory (one class, K = 1024), and
    a pair at IoU 0.4000000000000001: suppressed at 0.4 in float64."""
    cpu = _float64(_random(6, 3, 1024, False))
    cpu = cpu._replace(class_ids=torch.zeros_like(cpu.class_ids))
    got, ref = _nms_on_card_and_cpu(cpu, device, t=0.4, eps=0.0)
    assert torch.equal(got, ref)
    pair = Detections(torch.tensor([[[0.5, 0.5, 1.0, 1.0], [0.5, 0.2, 1.0, 0.4]]],
                                   dtype=torch.float64),
                      torch.tensor([[0.9, 0.8]], dtype=torch.float64),
                      torch.ones((1, 2), dtype=torch.int32), torch.ones((1, 2), dtype=torch.bool))
    got, ref = _nms_on_card_and_cpu(pair, device, t=0.4, eps=0.0)
    assert got.tolist() == ref.tolist() == [[True, False]]


def test_kernel_rejects_too_many_candidates(device):
    dets = Detections(*(t.to(device) for t in _random(0, 2, 1025, False)))
    with pytest.raises(ValueError):
        cuda_nms.nms(dets)


def _nms_on_card_and_cpu(cpu, device, t=0.45, eps=1e-6):
    got = cuda_nms.nms(Detections(*(x.to(device) for x in cpu)), t, eps=eps).valid
    torch.cuda.synchronize()
    return got.cpu(), cuda_nms.nms(cpu, t, eps=eps).valid


@pytest.mark.parametrize("eps", [1e-6, 0.0])
def test_kernel_batch_256_and_all_minus_inf_rows(device, eps):
    cpu = _random(256, 256, 98, False)
    scores = cpu.scores.clone()
    scores[1::7] = float("-inf")  # whole rows of valid candidates at -inf keep nothing
    cpu = cpu._replace(scores=scores, valid=cpu.valid.clone().fill_(True))
    got, ref = _nms_on_card_and_cpu(cpu, device, eps=eps)
    assert torch.equal(got, ref)
    assert not got[1::7].any() and got.any()


@pytest.mark.parametrize("single_box", [True, False])
def test_kernel_single_class_k1024(device, single_box):
    # The densest mask: one class, K = 1024 (identical boxes: every pair overlaps).
    cpu = _random(5, 3, 1024, False)
    boxes = cpu.boxes.clone()
    if single_box:
        boxes[:] = torch.tensor([0.5, 0.5, 0.3, 0.2])
    cpu = cpu._replace(boxes=boxes, class_ids=torch.zeros_like(cpu.class_ids))
    got, ref = _nms_on_card_and_cpu(cpu, device)
    assert torch.equal(got, ref)
    if single_box:
        assert got[1:].sum(dim=1).tolist() == [1, 1]


def _graph_equals_eager(fn):
    """Capture ``fn`` in a CUDA graph, replay it, and return (eager, replayed)."""
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up off the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    return eager, captured


@pytest.mark.parametrize("K", [98, 1024])
def test_kernel_replays_in_a_cuda_graph(device, K):
    gpu = Detections(*(t.to(device) for t in _random(K + 1, 16, K, True)))
    before = kernels.LAUNCHES["yolo_nms"]
    eager, replayed = _graph_equals_eager(lambda: cuda_nms.nms(gpu, 0.45).valid)
    # eager, warm-up, capture; a replay is no call
    assert kernels.LAUNCHES["yolo_nms"] == before + 3
    assert torch.equal(eager, replayed)


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
    names = ("yolo_bn_stats", "yolo_bn_normalize", "yolo_bn_bwd_reduce", "yolo_bn_bwd_dx")
    before = Counter(kernels.LAUNCHES)
    relayouts = fb.RELAYOUTS
    mean, var = fb.bn_stats(x)
    out = fb.bn_normalize(x, mul, add, residual, relu)
    s1, s2 = fb.bn_bwd_reduce(g, out, x, mean, r, relu)
    dx, dres = fb.bn_bwd_dx(g, out, x, mul, add, r, relu, res)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES - before == dict.fromkeys(names, 1)
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


# ------------------------------------------------------------ int8 serving
# Both int8 kernels round every step as their twins do, so they must agree
# bit for bit: no tolerance.
@pytest.mark.parametrize("shape", [(1, 448, 448), (3, 18, 10), (2, 64, 64)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_quant_s2d_kernel_equals_plain_twin(device, shape, dtype):
    from yolo_tpu_torch.serving import cuda_stem

    r = np.random.default_rng(sum(shape))
    n, h, w = shape
    if dtype == "uint8":
        images = r.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)
    else:
        images = r.normal(0, 1.5, size=(n, h, w, 3)).astype(np.float32)
    cpu = torch.from_numpy(images)
    s_img = torch.tensor(0.0173, dtype=torch.float32)
    before = kernels.LAUNCHES["yolo_quant_s2d"]
    got = cuda_stem.quant_s2d(cpu.to(device), s_img.to(device))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["yolo_quant_s2d"] == before + 1
    ref = cuda_stem.quant_s2d_reference(cpu, s_img)
    assert torch.equal(got.cpu(), ref)
    # ... and the twin on the card equals the twin on the CPU.
    assert torch.equal(cuda_stem.quant_s2d_reference(cpu.to(device), s_img.to(device)).cpu(), ref)


def _stem_images(seed, shape, dtype):
    r = np.random.default_rng(seed)
    if dtype == "uint8":
        return torch.from_numpy(r.integers(0, 256, size=(*shape, 3), dtype=np.uint8))
    return torch.from_numpy(r.normal(0, 1.5, size=(*shape, 3)).astype(np.float32))


# W/2 = 5, 7, 9 and 3 (not a multiple of the 4 pixels a unit), batch 256 at
# the slice's 448x448, and a view that starts 3 pixels into its storage (no
# unit aligned for the vector loads).
@pytest.mark.parametrize("shape", [(2, 6, 10), (3, 4, 14), (1, 8, 18), (5, 2, 6),
                                   (256, 448, 448), "offset"], ids=str)
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_quant_s2d_kernel_ragged_and_batch_256(device, shape, dtype):
    from yolo_tpu_torch.serving import cuda_stem

    if shape == "offset":
        images = _stem_images(3, (2, 18, 24), dtype).to(device).reshape(-1)[9:]
        images = images[: 2 * 18 * 22 * 3].reshape(2, 18, 22, 3)
    else:
        images = _stem_images(sum(shape), shape, dtype).to(device)
    s_img = torch.tensor(0.0173, dtype=torch.float32, device=device)
    got = cuda_stem.quant_s2d(images, s_img)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_stem.quant_s2d_reference(images, s_img))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_quant_s2d_kernel_replays_in_a_cuda_graph(device, dtype):
    from yolo_tpu_torch.serving import cuda_stem

    images = _stem_images(7, (4, 448, 448), dtype).to(device)
    s_img = torch.tensor(0.0173, dtype=torch.float32, device=device)
    before = kernels.LAUNCHES["yolo_quant_s2d"]
    eager, replayed = _graph_equals_eager(lambda: cuda_stem.quant_s2d(images, s_img))
    assert kernels.LAUNCHES["yolo_quant_s2d"] == before + 3
    assert torch.equal(eager, replayed)


# (N, H, W, Cin, Cout, K, stride, pad): every geometry class of the engine,
# with M and Cout not multiples of the tiles, ragged K (Cin = 3, 12) and
# fc1 as a 1x1 conv over a wide channel axis; fc1-like convs at M = 1, 16
# and 17 (split-K), the space-to-depth stem's 4-byte gather at an odd width
# (edge columns in the padding), and a persistent walk with more output
# tiles than the card has SMs.
CONV_CASES = [
    (2, 16, 16, 12, 64, 4, 1, ((2, 1), (2, 1))),  # s2d stem
    (2, 30, 30, 3, 64, 7, 2, 3),                  # direct stem
    (2, 9, 9, 64, 256, 1, 1, 0),                  # 1x1
    (2, 10, 10, 256, 512, 1, 2, 0),               # downsample, stride 2
    (3, 11, 7, 128, 128, 3, 1, 1),                # 3x3
    (2, 12, 12, 128, 128, 3, 2, 1),               # 3x3 stride 2 (the TPU kernel's case)
    (5, 1, 1, 3136, 96, 1, 1, 0),                 # fc1 as 1x1
    (1, 5, 5, 32, 2, 3, 1, 1),                    # Cout = 2
    (1, 1, 1, 4096, 96, 1, 1, 0),                 # fc1-like, M = 1
    (16, 1, 1, 4096, 96, 1, 1, 0),                # fc1-like, M = 16
    (17, 1, 1, 4096, 96, 1, 1, 0),                # fc1-like, M = 17
    (1, 9, 13, 12, 64, 4, 1, ((2, 1), (2, 1))),   # s2d stem, odd width
    (4, 56, 56, 64, 256, 1, 1, 0),                # 196 tiles of 128x128: persistent walk
]


def _conv_operands(case, seed=0):
    n, h, w, cin, cout, k, stride, pad = case
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.integers(-127, 128, size=(n, h, w, cin), dtype=np.int8))
    wq = torch.from_numpy(r.integers(-127, 128, size=(k, k, cin, cout), dtype=np.int8))
    # m scales the accumulator (up to ~127^2 * K) into roughly +-200, so the
    # rounding and both clips are exercised.
    m = torch.from_numpy(r.uniform(0.5, 1.5, cout).astype(np.float32)) / float(
        40 * np.sqrt(k * k * cin))
    t = torch.from_numpy(r.uniform(-3, 3, cout).astype(np.float32))
    return x, wq, m, t


def _check_conv_modes(device, case, seed):
    """Every epilogue of the kernel at ``case`` == the float64 twin, bit for bit."""
    from yolo_tpu_torch.serving import cuda_int8

    x, wq, m, t = _conv_operands(case, seed=seed)
    stride, pad = case[6], case[7]
    ho, wo = cuda_int8.out_size(x.shape[1], x.shape[2], wq.shape[0], wq.shape[1], stride, pad)
    res = torch.from_numpy(np.random.default_rng(7).integers(
        -127, 128, size=(x.shape[0], ho, wo, wq.shape[3]), dtype=np.int8))
    r = torch.tensor(0.7, dtype=torch.float32)
    gpu = lambda v: v.to(device)  # noqa: E731
    wk = cuda_int8.pack_weight(gpu(wq))
    for mode in cuda_int8.MODES:
        extra = dict(res=res, r=r) if mode == "residual" else {}
        ref = cuda_int8.conv_int8_reference(x, wq, m, t, stride, pad, mode, **extra)
        before = kernels.LAUNCHES["yolo_int8_conv"]
        got = cuda_int8.conv_int8(gpu(x), gpu(wq), gpu(m), gpu(t), stride, pad, mode,
                                  wk=wk, **{k: gpu(v) for k, v in extra.items()})
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["yolo_int8_conv"] == before + 1
        assert got.dtype == ref.dtype and got.shape == ref.shape, mode
        assert torch.equal(got.cpu(), ref), mode


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(map(str, c[:7])))
@pytest.mark.parametrize("tile", [0, 1, 2, 3])
def test_int8_conv_kernel_equals_plain_twin(device, monkeypatch, case, tile):
    from yolo_tpu_torch.serving import cuda_int8

    assert len(cuda_int8.TILES) == 4
    monkeypatch.setattr(cuda_int8, "plan", lambda m_rows, cout, k: (tile, 1))
    _check_conv_modes(device, case, seed=tile)


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(map(str, c[:7])))
def test_int8_conv_split_k_equals_plain_twin(device, monkeypatch, case):
    """Every divisor of the K stages up to 8 as the splits, on plan()'s tile:
    the int32 partials are exact, so every split gives the same bits."""
    from yolo_tpu_torch.serving import cuda_int8

    n, h, w, cin, cout, k, stride, pad = case
    ho, wo = cuda_int8.out_size(h, w, k, k, stride, pad)
    tile, _ = cuda_int8.plan(n * ho * wo, cout, k * k * cin)
    stages = cuda_int8.k_stages(k * k * cin)
    for splits in [d for d in range(1, 9) if stages % d == 0]:
        monkeypatch.setattr(cuda_int8, "plan", lambda m_rows, co, kk, s=splits: (tile, s))
        _check_conv_modes(device, case, seed=splits)


def test_int8_conv_rejects_what_the_kernel_does_not_take(device):
    from yolo_tpu_torch.serving import cuda_int8

    x, wq, m, t = (v.to(device) for v in _conv_operands((1, 4, 4, 16, 8, 1, 1, 0)))
    with pytest.raises(ValueError):
        cuda_int8.conv_int8(x.permute(0, 2, 1, 3), wq, m, t)  # not contiguous
    with pytest.raises(ValueError):
        cuda_int8.conv_int8(x, wq, m, t, mode="residual")  # no residual operand
    with pytest.raises(ValueError):
        cuda_int8.conv_int8(x, wq[..., :7], m[:7], t[:7])  # odd Cout


def test_int8_engine_on_the_card_equals_the_cpu_engine(device):
    """A small int8 engine through both kernels on the card against the same
    q-params on the CPU (the twins): every int8 activation is exact, so the
    grids differ only by the float32 FC sums' order."""
    from yolo_tpu_torch.models import create_model
    from yolo_tpu_torch.serving.engine import build_int8_predict, int8_forward, to_device

    model = create_model("resnet", 20, 7, 2, device="cpu", stage_sizes=(1, 1, 1, 1),
                         image_size=64, generator=torch.Generator().manual_seed(0))
    r = np.random.default_rng(3)
    calib = torch.from_numpy(r.normal(size=(4, 64, 64, 3)).astype(np.float32))
    _, q = build_int8_predict(model, [calib])
    images = torch.from_numpy(r.integers(0, 256, size=(3, 64, 64, 3), dtype=np.uint8))
    ref = int8_forward(q, images)
    before = Counter(kernels.LAUNCHES)
    got = int8_forward(to_device(q, device), images.to(device))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES - before == {"yolo_quant_s2d": 1, "yolo_max_pool_int8": 1,
                                         "yolo_int8_conv": 1 + 4 * 3 + 4 + 4 + 1}
    tol = 1e-5 * float(ref.abs().max()) + 1e-6
    assert float((got.cpu() - ref).abs().max()) <= tol


# ------------------------------------------------- dynamic int8 quantize
# Int8Conv2d's per-tensor input quantize (csrc/dyn_quant.cu) divides and
# rounds as its twin does and takes an exact max: bit for bit, no tolerance.
# The edge cases are shared with the CPU test of the twin
# (tests/test_torch_quantized.py).
DYNQ_CASES = ("odd numel", "three elements", "unaligned", "nchw", "bfloat16", "zeros", "ties",
              "near ties", "beyond 127 s", "tiny", "wide range")


def _beyond_127_amax(r) -> np.float32:
    """An amax whose float32 scale amax / 127 rounds down, so amax / s > 127."""
    for a in r.uniform(0.5, 8.0, size=4096).astype(np.float32):
        if a / (a / np.float32(127)) > np.float32(127):
            return a
    raise AssertionError("no amax with amax / s > 127 among 4096 draws")


def dynq_input(case: str, device="cpu") -> torch.Tensor:
    """One edge case of the quantize's input as an NCHW tensor on ``device``
    (channels_last memory, as the models hold it, unless the case says otherwise)."""
    r = np.random.default_rng(DYNQ_CASES.index(case))
    shape = (2, 9, 11, 6)  # NHWC
    if case == "odd numel":
        a = r.normal(size=(1, 5, 7, 3))
    elif case == "three elements":
        a = r.normal(size=(1, 1, 1, 3))
    elif case == "zeros":
        a = np.zeros(shape)
        a[0, 0, :, 0] = -0.0
    elif case == "ties":  # s = 2^-5 exactly, every x / s a half-integer
        s = 2.0 ** -5
        a = (r.integers(-127, 127, size=shape) + 0.5) * s
        a[0, 0, 0, 0] = 127 * s
    elif case in ("near ties", "beyond 127 s"):
        amax = np.float32(5.3) if case == "near ties" else _beyond_127_amax(r)
        s = np.maximum(amax / np.float32(127), np.float32(1e-8))
        a = ((r.integers(-127, 127, size=shape) + np.float32(0.5)) * s).astype(np.float32)
        step = r.integers(-1, 2, size=shape)  # the product, or one ulp down or up
        a = np.where(step == 0, a, np.nextafter(a, np.where(step < 0, -np.inf, np.inf)
                                                .astype(np.float32)))
        a[0, 0, 0, :2] = (amax, -amax)
    elif case == "tiny":  # amax / 127 under 1e-8: s = 1e-8
        a = r.uniform(-1e-7, 1e-7, size=shape)
    elif case == "wide range":
        a = r.normal(size=shape) * 10.0 ** r.integers(-30, 30, size=shape)
    else:  # "unaligned", "nchw", "bfloat16"
        a = r.normal(size=shape) * 3
    x = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
    if case == "unaligned":  # a view that starts one float into its storage
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
        flat[1:] = x.reshape(-1)
        x = flat[1:].view(x.shape)
    elif case == "bfloat16":
        x = x.bfloat16()
    x = x.permute(0, 3, 1, 2)
    return x.contiguous() if case == "nchw" else x


def _dynq_on_card_equals_twin(x):
    from yolo_tpu_torch.serving import cuda_dynq

    c127 = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    before = kernels.LAUNCHES["yolo_dynq"]
    xq, s_x = cuda_dynq.quantize(x, c127)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["yolo_dynq"] == before + 1
    ref_q, ref_s = cuda_dynq.quantize_reference(x, c127)
    n, c, h, w = x.shape
    assert xq.shape == (n, h, w, c) and xq.dtype == torch.int8 and xq.is_contiguous()
    assert s_x.shape == () and s_x.dtype == torch.float32
    assert torch.equal(s_x, ref_s) and torch.equal(xq, ref_q)
    return xq, s_x


@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("conv", range(24), ids=lambda i: f"conv{i:02d}")
def test_dynq_kernel_equals_plain_twin_at_the_24conv_inputs(device, conv, batch):
    """Every conv input of the 24-conv model at 448x448: the normalized
    image, then LeakyReLU outputs."""
    from yolo_tpu_torch.data.transforms import device_normalize
    from yolo_tpu_torch.models.backbones import yolov1_conv_inputs

    c, h, w = yolov1_conv_inputs(448)[conv]
    g = torch.Generator(device=device).manual_seed(100 * batch + conv)
    if conv == 0:
        x = device_normalize(torch.randint(0, 256, (batch, h, w, c), generator=g,
                                           device=device, dtype=torch.uint8))
    else:
        x = torch.nn.functional.leaky_relu(
            torch.randn(batch, h, w, c, generator=g, device=device) * 2, 0.1)
    _dynq_on_card_equals_twin(x.permute(0, 3, 1, 2))


@pytest.mark.parametrize("case", DYNQ_CASES)
def test_dynq_kernel_equals_plain_twin_on_edge_cases(device, case):
    from yolo_tpu_torch.serving import cuda_dynq

    x = dynq_input(case, device)
    if case == "unaligned":
        assert x.data_ptr() % 16 != 0
    xq, s_x = _dynq_on_card_equals_twin(x)
    # ... and the twin on the card equals the twin on the CPU.
    ref_q, ref_s = cuda_dynq.quantize_reference(x.cpu(), torch.tensor(127.0))
    assert torch.equal(xq.cpu(), ref_q) and torch.equal(s_x.cpu(), ref_s)
    if case == "zeros":
        assert float(s_x) == float(np.float32(1e-8)) and not xq.any()


def test_dynq_kernel_replays_in_a_cuda_graph_on_new_data(device):
    """Captured once on one batch, a replay on the next batch's data in the
    same buffer gives that batch's scale and x_q."""
    from yolo_tpu_torch.serving import cuda_dynq

    def batch(seed, scale):
        g = torch.Generator(device=device).manual_seed(seed)
        return torch.randn(4, 28, 28, 256, generator=g, device=device) * scale

    static = batch(0, 1.0)
    c127 = torch.full((), 127.0, dtype=torch.float32, device=device)
    before = kernels.LAUNCHES["yolo_dynq"]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_dynq.quantize(static.permute(0, 3, 1, 2), c127)  # warm up off the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        xq, s_x = cuda_dynq.quantize(static.permute(0, 3, 1, 2), c127)
    for seed, scale in ((1, 3.0), (2, 0.25)):
        static.copy_(batch(seed, scale))
        graph.replay()
        torch.cuda.synchronize()
        ref_q, ref_s = cuda_dynq.quantize_reference(static.permute(0, 3, 1, 2), c127)
        assert torch.equal(s_x, ref_s) and torch.equal(xq, ref_q)
    assert kernels.LAUNCHES["yolo_dynq"] == before + 2  # warm-up, capture; a replay is no call


def test_dynq_kernel_rejects_what_it_does_not_take(device):
    from yolo_tpu_torch.serving import cuda_dynq

    c127 = torch.full((), 127.0, dtype=torch.float32, device=device)
    with pytest.raises(ValueError, match="empty"):
        cuda_dynq.quantize(torch.ones(0, 3, 4, 4, device=device), c127)
    with pytest.raises(ValueError, match="NCHW"):
        cuda_dynq.quantize(torch.ones(3, 4, 4, device=device), c127)


# ------------------------------------------------------------ int8 max-pool
# The engine's 3x3/s2/p1 max-pool after the stem (csrc/max_pool_int8.cu):
# integers only, so bit for bit with its twin. The cases are shared with the
# CPU test of the wrapper against JAX's reduce_window
# (tests/test_torch_serving.py).
POOL_CASES = {
    "stem b2": (2, 224, 224, 64),  # the flagship's stem output
    "1x1": (1, 1, 1, 64),
    "2x3": (1, 2, 3, 64),
    "7x7": (2, 7, 7, 64),
    "9x15": (1, 9, 15, 64),
    "9x15 c16": (2, 9, 15, 16),
    "17x33 c128": (3, 17, 33, 128),  # a partial strip; warps across rows
    "c512": (1, 6, 5, 512),  # a pixel is a warp
    "c1024": (1, 5, 4, 1024),  # a pixel spans two warps
    "all -128": (2, 10, 12, 64),
    "127 at borders": (2, 11, 12, 64),
}


def pool_input(case: str, device="cpu") -> torch.Tensor:
    """One case of the max-pool's int8 NHWC input on ``device``."""
    shape = POOL_CASES[case]
    if case in ("all -128", "127 at borders"):
        a = np.full(shape, -128, np.int8)
        if case == "127 at borders":  # the border windows hold 127 and the padding
            a[:, [0, -1]] = 127
            a[:, :, [0, -1]] = 127
    else:
        a = np.random.default_rng(sorted(POOL_CASES).index(case)).integers(
            -128, 128, size=shape, dtype=np.int8)
    return torch.from_numpy(a).to(device)


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_max_pool_kernel_equals_plain_twin(device, case):
    from yolo_tpu_torch.serving import cuda_pool

    x = pool_input(case, device)
    before = kernels.LAUNCHES["yolo_max_pool_int8"]
    got = cuda_pool.max_pool_int8(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["yolo_max_pool_int8"] == before + 1
    want = cuda_pool.max_pool_int8_reference(x)
    n, h, w, c = x.shape
    assert got.shape == (n, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c) == want.shape
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), cuda_pool.max_pool_int8_reference(x.cpu()))
    if case == "all -128":
        assert bool((got == -128).all())
    if case == "127 at borders":  # every window on the border: 127, never the padding
        assert bool((got[:, [0, -1]] == 127).all() and (got[:, :, [0, -1]] == 127).all())
        assert bool((got[:, 1:-1, 1:-1] == -128).all())


def test_max_pool_kernel_replays_in_a_cuda_graph_on_new_data(device):
    from yolo_tpu_torch.serving import cuda_pool

    g = torch.Generator(device=device).manual_seed(5)
    static = torch.randint(-128, 128, (4, 56, 56, 64), generator=g, device=device,
                           dtype=torch.int8)
    before = kernels.LAUNCHES["yolo_max_pool_int8"]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_pool.max_pool_int8(static)  # warm up off the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cuda_pool.max_pool_int8(static)
    for _ in range(2):
        static.copy_(torch.randint(-128, 128, static.shape, generator=g, device=device,
                                   dtype=torch.int8))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, cuda_pool.max_pool_int8(static))
        assert torch.equal(out, cuda_pool.max_pool_int8_reference(static))
    # warm-up, capture, two eager checks
    assert kernels.LAUNCHES["yolo_max_pool_int8"] == before + 4


def test_max_pool_kernel_rejects_what_it_does_not_take(device):
    from yolo_tpu_torch.serving import cuda_pool

    x = torch.zeros(2, 8, 8, 64, dtype=torch.int8, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_pool.max_pool_int8(x.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_pool.max_pool_int8(x[:, :, :, :32])
    with pytest.raises(ValueError, match="aligned"):  # contiguous, one byte into its storage
        cuda_pool.max_pool_int8(x.reshape(-1)[1:1 + 2 * 8 * 8 * 16].view(2, 8, 8, 16))
    with pytest.raises(TypeError, match="int8"):
        cuda_pool.max_pool_int8(x.to(torch.uint8))
    with pytest.raises(TypeError, match="int8"):
        cuda_pool.max_pool_int8(x.float())
    with pytest.raises(ValueError, match="multiple of 16"):
        cuda_pool.max_pool_int8(x[..., :24].contiguous())
    with pytest.raises(ValueError, match="non-empty"):
        cuda_pool.max_pool_int8(x[:0])
    with pytest.raises(ValueError, match="non-empty"):
        cuda_pool.max_pool_int8(x[0])


# ------------------------------------------------------- fused bottlenecks
def random_qblock(seed, cin, c, p, ds=False):
    """Seeded q-params of one bottleneck block in the engine's layout (numpy):
    int8 HWIO weights, float32 m and t that scale each accumulator to about
    +-130 (so the rounding, the ReLU and both clips occur), and rx, or the
    downsample projection with ds_rescale."""
    r = np.random.default_rng(seed)

    def conv(k, ci, co):
        return {"wq": r.integers(-127, 128, size=(k, k, ci, co), dtype=np.int8),
                "m": (r.uniform(0.5, 1.5, co) / (40 * np.sqrt(k * k * ci))).astype(np.float32),
                "t": r.uniform(-3, 3, co).astype(np.float32)}

    qb = {"conv1": conv(1, cin, p), "conv2": conv(3, p, p), "conv3": conv(1, p, c),
          "downsample": conv(1, cin, c) if ds else None}
    if ds:
        qb["ds_rescale"], qb["rx"] = np.float32(0.7), None
    else:
        qb["rx"] = np.float32(0.9)
    return qb


def _on(qb, device):
    from yolo_tpu_torch.serving.engine import to_device

    return to_device(qb, device)


def _x(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).integers(-127, 128, size=shape,
                                                                 dtype=np.int8))


# (N, H, W, C, P): ragged tiles (H, W not multiples of the tile), both tile
# sizes, and the widths of layer1 and layer2.
BLOCK_CASES = [(2, 12, 10, 64, 64), (1, 14, 14, 128, 64), (3, 8, 9, 256, 64),
               (2, 7, 7, 512, 128)]


@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: "x".join(map(str, c)))
def test_bottleneck_kernel_equals_plain_twin(device, case):
    from yolo_tpu_torch.serving import cuda_bottleneck as cb

    n, h, w, c, p = case
    qb = random_qblock(sum(case), c, c, p)
    x = _x(1, (n, h, w, c))
    ref = cb.block_int8_reference(x, _on(qb, "cpu"))
    before = kernels.LAUNCHES["yolo_int8_bottleneck"]
    got = cb.block_int8(x.to(device), _on(qb, device))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["yolo_int8_bottleneck"] == before + 1
    assert torch.equal(got.cpu(), ref)


# (N, H, W, Cin, C, P, blocks, downsample): a ds first block (layer1's
# shape class), identity chains, one block, and a chain of 256 tiles (8 x 16),
# more than the card holds at once (one thread block an SM), so that
# resident blocks each walk several tiles between grid barriers.
CHAIN_CASES = [(2, 12, 10, 64, 256, 64, 3, True), (2, 9, 9, 128, 128, 64, 2, False),
               (1, 14, 14, 128, 128, 64, 1, False), (3, 16, 11, 64, 128, 64, 4, True),
               (2, 7, 7, 256, 256, 128, 3, False), (8, 64, 64, 64, 64, 64, 2, False)]


@pytest.mark.parametrize("case", CHAIN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_chain_kernel_equals_plain_twin(device, case):
    from yolo_tpu_torch.serving import cuda_bottleneck as cb

    n, h, w, cin, c, p, nb, ds = case
    qbs = [random_qblock(10 * b + nb, cin if b == 0 else c, c, p, ds=ds and b == 0)
           for b in range(nb)]
    x = _x(2, (n, h, w, cin))
    ref = cb.chain_int8_reference(x, [_on(qb, "cpu") for qb in qbs])
    before = Counter(kernels.LAUNCHES)
    got = cb.chain_int8(x.to(device), [_on(qb, device) for qb in qbs])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES - before == {"yolo_int8_chain": 1}
    tiles = cb.plan(n, h, w, cin, c, p, ds=ds).tiles
    assert 0 < cb.LAST_GRID <= tiles
    assert torch.equal(got.cpu(), ref)


# Every tile plan() can return, forced, on ragged images (13 and 15 leave
# 7-wide, 8-wide and narrower remainders; 9 rows), the downsample block, a
# chain of the 8-block limit, and P = 128 (two column halves a stage).
TILE_CHAIN_CASES = [(2, 13, 15, 64, 256, 64, 2, True), (1, 9, 15, 128, 128, 128, 2, False),
                    (1, 15, 13, 64, 128, 64, 8, True)]


@pytest.mark.parametrize("tile", [(8, 16), (16, 8), (14, 7), (8, 8), (7, 7)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", TILE_CHAIN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_chain_kernel_on_every_tile_equals_plain_twin(device, case, tile):
    from yolo_tpu_torch.serving import cuda_bottleneck as cb

    assert tile in cb.TILES
    n, h, w, cin, c, p, nb, ds = case
    qbs = [random_qblock(7 * b + nb, cin if b == 0 else c, c, p, ds=ds and b == 0)
           for b in range(nb)]
    x = _x(3, (n, h, w, cin))
    ref = cb.chain_int8_reference(x, [_on(qb, "cpu") for qb in qbs])
    got = cb.chain_int8(x.to(device), [_on(qb, device) for qb in qbs], tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)
    xi = _x(4, (n, h, w, c))
    qb = qbs[1]
    got = cb.block_int8(xi.to(device), _on(qb, device), tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cb.block_int8_reference(xi, _on(qb, "cpu")))


def test_bottleneck_kernels_reject_what_they_do_not_take(device):
    from yolo_tpu_torch.serving import cuda_bottleneck as cb

    qb = _on(random_qblock(0, 32, 32, 64), device)
    with pytest.raises(ValueError, match="multiples of 64"):
        cb.block_int8(_x(0, (1, 8, 8, 32)).to(device), qb)
    qb = _on(random_qblock(0, 64, 64, 64), device)
    with pytest.raises(ValueError, match="contiguous"):
        cb.chain_int8(_x(0, (1, 8, 8, 64)).to(device).permute(0, 2, 1, 3), [qb])
    with pytest.raises(ValueError, match="on x's device"):
        cb.chain_int8(_x(0, (1, 8, 8, 64)).to(device), [_on(random_qblock(0, 64, 64, 64), "cpu")])


def test_int8_engine_with_stage_chains_on_the_card(device):
    """A small int8 engine (2 blocks a stage, 64x64) with the chain kernel on
    every stage equals the same engine on the card without it, bit for bit,
    and launches 1 chain per stage and 1 + 3 * 4 + 4 + 1 int8 convs."""
    from yolo_tpu_torch.models import create_model
    from yolo_tpu_torch.serving import cuda_bottleneck as cb
    from yolo_tpu_torch.serving.engine import build_int8_predict, int8_forward

    model = create_model("resnet", 20, 7, 2, device=device, stage_sizes=(2, 2, 2, 2),
                         image_size=64, generator=torch.Generator(device=device).manual_seed(0))
    r = np.random.default_rng(4)
    calib = torch.from_numpy(r.normal(size=(4, 64, 64, 3)).astype(np.float32)).to(device)
    _, q = build_int8_predict(model, [calib])
    images = torch.from_numpy(r.integers(0, 256, size=(3, 64, 64, 3), dtype=np.uint8)).to(device)
    ref = int8_forward(q, images)
    impl = {f"layer{i}": cb.chain_int8 for i in range(1, 5)}
    before = Counter(kernels.LAUNCHES)
    got = int8_forward(q, images, impl=impl)
    torch.cuda.synchronize()
    grew = kernels.LAUNCHES - before
    assert grew["yolo_int8_chain"] == 4
    assert grew["yolo_int8_conv"] == 1 + 3 * 4 + 4 + 1
    assert torch.equal(got, ref)


# ------------------------------------------------------------- Winograd conv
def random_qwino(seed, c, k):
    """Seeded per-tap Winograd q-params (numpy, winograd.wino_quantize's
    layout): int8 taps U, mw that scales each output to about +-100 (so the
    rounding, the activation and both clips occur), bias and per-tap dinv
    that make some taps clip."""
    r = np.random.default_rng(seed)
    return {"uq": r.integers(-127, 128, size=(16, c, k), dtype=np.int8),
            "mw": (r.uniform(0.5, 1.5, (16, 1, k)) * 6e-3 / np.sqrt(c)).astype(np.float32),
            "t": r.uniform(-3, 3, k).astype(np.float32),
            "dinv": r.uniform(0.2, 0.6, (16, 1, 1)).astype(np.float32)}


# (N, H, W): one tile, an even square, odd and non-square images (the
# surplus output row / column cropped), several M-tiles of 32.
WINO_SHAPES = [(n, h, w) for n in (1, 3) for h, w in ((1, 1), (2, 2), (7, 7), (7, 9), (8, 8),
                                                       (14, 14))]


@pytest.mark.parametrize("shape", WINO_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("ck", [(64, 128), (128, 64)], ids=lambda ck: f"{ck[0]}to{ck[1]}")
@pytest.mark.parametrize("leaky", [True, False], ids=["leaky", "relu"])
def test_wino_kernel_equals_plain_twin(device, shape, ck, leaky):
    from yolo_tpu_torch.serving import cuda_wino

    c, k = ck
    qw = random_qwino(sum(shape) + c, c, k)
    x = _x(3, (*shape, c))
    ref = cuda_wino.conv3x3_wino_reference(x, {"wino": _on(qw, "cpu")}, leaky)
    before = Counter(kernels.LAUNCHES)
    got = cuda_wino.conv3x3_wino(x.to(device), {"wino": _on(qw, device)}, leaky)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES - before == dict.fromkeys(cuda_wino.ENTRIES["full"], 1)
    assert got.dtype == torch.int8 and got.shape == ref.shape == (*shape, k)
    assert torch.equal(got.cpu(), ref)


# Every tile plan() can pick, forced: at a ragged Mt (odd H and W at batch
# 3: 3 * 7 * 6 = 126 tiles) and at 2 * 14 * 14 = 392 tiles (several units a
# block); C = 192 ends each tap in a half-empty 128-byte stage.
@pytest.mark.parametrize("shape", [(3, 13, 11), (2, 28, 28)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("tile", [0, 1], ids=["128x64", "64x64"])
def test_wino_every_plan_tile_equals_twin(device, monkeypatch, shape, tile):
    from yolo_tpu_torch.serving import cuda_wino

    assert len(cuda_wino.TILES) == 2
    qw = random_qwino(sum(shape) + tile, 192, 128)
    x = _x(5, (*shape, 192))
    ref = cuda_wino.conv3x3_wino_reference(x, {"wino": _on(qw, "cpu")}, False)
    monkeypatch.setattr(cuda_wino, "plan", lambda *a: tile)
    got = cuda_wino.conv3x3_wino(x.to(device), {"wino": _on(qw, device)}, False)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("mode", ["full", "taps", "dots", "dots-raw"])
@pytest.mark.parametrize("shape", [(2, 7, 9), (1, 14, 14)], ids=lambda s: "x".join(map(str, s)))
def test_wino_ablation_modes_equal_their_twins(device, mode, shape):
    from yolo_tpu_torch.serving import cuda_wino

    qw = random_qwino(5, 128, 128)
    x = _x(4, (*shape, 128))
    ref = cuda_wino.wino_ablate(x, _on(qw, "cpu"), mode)
    before = Counter(kernels.LAUNCHES)
    got = cuda_wino.wino_ablate(x.to(device), _on(qw, device), mode)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES - before == {name: 1 for name in cuda_wino.ENTRIES[mode]}
    assert torch.equal(got.cpu(), ref)


def test_wino_kernel_rejects_what_it_does_not_take(device):
    from yolo_tpu_torch.serving import cuda_wino

    qw = _on(random_qwino(0, 96, 64), device)
    with pytest.raises(ValueError, match="multiples of 64"):
        cuda_wino.conv3x3_wino(_x(0, (1, 8, 8, 96)).to(device), {"wino": qw})
    qw = _on(random_qwino(0, 64, 64), device)
    with pytest.raises(ValueError, match="on x's device"):
        cuda_wino.conv3x3_wino(_x(0, (1, 8, 8, 64)).to(device),
                               {"wino": {**_on(random_qwino(0, 64, 64), "cpu"), "uk": qw["uk"]}})
    with pytest.raises(ValueError, match="contiguous"):
        cuda_wino.conv3x3_wino(_x(0, (1, 8, 8, 64)).to(device).permute(0, 2, 1, 3),
                               {"wino": qw})
    with pytest.raises(ValueError, match="K <= C"):
        cuda_wino.wino_ablate(_x(0, (1, 8, 8, 64)).to(device),
                              _on(random_qwino(0, 64, 128), device), "taps")


def test_int8_engine_with_wino_convs_on_the_card(device):
    """A small int8 engine (2 blocks a stage, 64x64) with every Winograd point
    through the kernel equals the same engine with the twin on the card, bit
    for bit, and launches 8 Winograd convs (a tap pass and a tap GEMM each)
    and 26 int8 convs (34 less the 8)."""
    from yolo_tpu_torch.models import create_model
    from yolo_tpu_torch.serving import winograd
    from yolo_tpu_torch.serving.engine import build_int8_predict, int8_forward

    model = create_model("resnet", 20, 7, 2, device=device, stage_sizes=(2, 2, 2, 2),
                         image_size=64, generator=torch.Generator(device=device).manual_seed(0))
    r = np.random.default_rng(4)
    calib = torch.from_numpy(r.normal(size=(4, 64, 64, 3)).astype(np.float32)).to(device)
    wino = winograd.valid_points((2, 2, 2, 2))
    assert len(wino) == 8
    _, q = build_int8_predict(model, [calib], wino=wino)
    images = torch.from_numpy(r.integers(0, 256, size=(3, 64, 64, 3), dtype=np.uint8)).to(device)
    twin = int8_forward(q, images, impl=winograd.wino_impl_hooks(
        wino, conv=winograd.conv3x3_wino_rq))
    before = Counter(kernels.LAUNCHES)
    got = int8_forward(q, images, impl=winograd.wino_impl_hooks(wino))
    torch.cuda.synchronize()
    grew = kernels.LAUNCHES - before
    assert grew["yolo_int8_wino_taps"] == grew["yolo_int8_wino_gemm"] == 8
    assert grew["yolo_int8_conv"] == 1 + 3 * 8 + 4 + 4 + 1 - 8
    assert torch.equal(got, twin)


# ------------------------------------------------------- experiments/ kernels
@pytest.mark.parametrize("shape", [(512, 256), (7, 13), (1, 1), (3, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_adam_kernel_equals_plain_twin(device, shape):
    from yolo_tpu_torch.experiments import opt_update_microbench as om

    r = np.random.default_rng(shape[0])
    p, m, v, g = (torch.from_numpy(r.standard_normal(shape, dtype=np.float32)).to(device)
                  for _ in range(4))
    v.abs_()
    scalars = om.bias_scalars(0.7, 9, 3e-4, device)
    ref = om.plain_update(p, m, v, g, scalars)
    before = kernels.LAUNCHES["yolo_adam_update"]
    got = om.cuda_update(p, m, v, g, scalars)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["yolo_adam_update"] == before + 1
    assert got[0] is p and got[1] is m and got[2] is v  # in place
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_adam_kernel_matches_torch_adam(device):
    from yolo_tpu_torch.experiments import opt_update_microbench as om

    assert om.check_vs_torch_adam(device="cuda") < 1e-5


@pytest.mark.parametrize("kn", [(300, 256), (192, 64), (1152, 128), (512, 512), (256, 64),
                                (4, 2)], ids=lambda kn: f"K{kn[0]}N{kn[1]}")
@pytest.mark.parametrize("M", [64, 4096 + 17])
def test_int8_dot_kernel_equals_plain_twin(device, kn, M):
    from yolo_tpu_torch.experiments import mosaic_int8_dot as md

    K, N = kn
    r = np.random.default_rng(K + M)
    a = torch.from_numpy(r.integers(-127, 128, size=(M, K), dtype=np.int8))
    w = torch.from_numpy(r.integers(-127, 128, size=(K, N), dtype=np.int8))
    m = torch.from_numpy((r.uniform(0.5, 1.5, N) * (2e-2 / np.sqrt(K))).astype(np.float32))
    ref = md.int8_dot_reference(a, w, m)
    assert 0 < int((ref.abs() == 127).sum()) < ref.numel()  # both clips and the interior
    before = kernels.LAUNCHES["yolo_int8_conv"]
    got = md.int8_dot(a.to(device), w.to(device), m.to(device))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["yolo_int8_conv"] == before + 1
    assert torch.equal(got.cpu(), ref)


# (n, H, W, C, K): the harness's layer3 geometry at batch 2, odd and
# non-square images, C = 16 (a 32-value K stage spans two taps), K < 128.
# H = 13 at n = 1 at the harness's width; 196 tiles of 128x128 (a
# persistent walk over more tiles than SMs).
CONV_BF16_CASES = [(2, 28, 28, 256, 256), (1, 13, 11, 32, 24), (2, 8, 8, 16, 16),
                   (3, 7, 7, 64, 136), (1, 13, 13, 256, 256), (32, 28, 28, 32, 128)]


@pytest.mark.parametrize("case", CONV_BF16_CASES, ids=lambda c: "x".join(map(str, c)))
def test_bf16_conv_stats_kernel_equals_plain_twin(device, case):
    from yolo_tpu_torch.experiments import conv_bn_fuse_bench as cb

    n, h, w, c, k = case
    r = np.random.default_rng(sum(case))
    x = torch.from_numpy(r.standard_normal((n, h, w, c), dtype=np.float32)).to(device)
    w9 = torch.from_numpy(r.standard_normal((9, c, k), dtype=np.float32) / np.sqrt(9 * c))
    x, w9 = x.to(torch.bfloat16), w9.to(device, torch.bfloat16)
    ref, ref_s = cb.conv3x3_bf16_reference(x, w9, stats=True)
    acc = cb.conv3x3_acc_reference(x, w9).double()
    before = kernels.LAUNCHES["yolo_bf16_conv3x3"]
    y0, _ = cb.conv3x3_bf16(x, w9)
    y, s = cb.conv3x3_bf16(x, w9, stats=True)
    _, s2 = cb.conv3x3_bf16(x, w9, stats=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["yolo_bf16_conv3x3"] == before + 3
    assert torch.equal(y0, y) and torch.equal(s, s2)  # stats identical run to run
    err = (y.float() - ref.float()).abs().max()
    assert float(err) <= bf16_ulp(float(ref.float().abs().max()))
    tol = 1e-5 * torch.stack([acc.abs().sum((0, 1, 2)), (acc * acc).sum((0, 1, 2))])
    assert bool(((s.double() - ref_s).abs() <= tol).all())


# (N, H, W, CIN, P): layer1 widths at two sizes, odd H and W, an H that a
# 16-row tile does not divide, the narrowest widths the kernel takes.
BOTTLENECK_BF16_CASES = [(2, 16, 16, 256, 64), (1, 13, 13, 256, 64), (1, 34, 8, 32, 16),
                         (2, 9, 20, 64, 32), (1, 7, 5, 16, 16)]


@pytest.mark.parametrize("case", BOTTLENECK_BF16_CASES, ids=lambda c: "x".join(map(str, c)))
def test_bf16_bottleneck_kernel_equals_plain_twin(device, case):
    from yolo_tpu_torch.experiments import fused_block_pallas as fb

    args = fb.random_block(*case, device, seed=sum(case))
    ref = fb.reference(*args).float()
    before = kernels.LAUNCHES["yolo_bf16_bottleneck"]
    got = fb.fused_bottleneck(*args).float()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["yolo_bf16_bottleneck"] == before + 1
    assert not bool(got.isnan().any())
    assert float((got - ref).abs().max()) <= 2 * bf16_ulp(float(ref.abs().max()))


# Every tile plan() can return, forced, at layer1's widths on ragged 13x13
# and 9x15 images and at the narrowest widths.
@pytest.mark.parametrize("tile", [(8, 16), (16, 8), (14, 7), (8, 8), (7, 7)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", [(1, 13, 13, 256, 64), (2, 9, 15, 64, 32), (1, 13, 13, 16, 16)],
                         ids=lambda c: "x".join(map(str, c)))
def test_bf16_bottleneck_on_every_tile_equals_plain_twin(device, case, tile):
    from yolo_tpu_torch.experiments import fused_block_pallas as fb

    args = fb.random_block(*case, device, seed=3 * sum(case))
    ref = fb.reference(*args).float()
    got = fb.fused_bottleneck(*args, tile=tile).float()
    torch.cuda.synchronize()
    assert not bool(got.isnan().any())
    assert float((got - ref).abs().max()) <= 2 * bf16_ulp(float(ref.abs().max()))


def test_experiment_kernels_reject_what_they_do_not_take(device):
    from yolo_tpu_torch.experiments import conv_bn_fuse_bench as cb
    from yolo_tpu_torch.experiments import fused_block_pallas as fb
    from yolo_tpu_torch.experiments import mosaic_int8_dot as md
    from yolo_tpu_torch.experiments import opt_update_microbench as om

    p = torch.zeros((4, 4), device=device)
    with pytest.raises(ValueError, match="float32"):
        om.cuda_update(p, p.clone(), p.clone(), p.double(), om.bias_scalars(1.0, 1, 1e-4, device))
    with pytest.raises(ValueError, match="scalars"):
        om.cuda_update(p, p.clone(), p.clone(), p.clone(), torch.zeros(3, device=device))
    a = torch.zeros((8, 6), dtype=torch.int8, device=device)
    with pytest.raises(ValueError, match="K % 4"):
        md.int8_dot(a, torch.zeros((6, 8), dtype=torch.int8, device=device),
                    torch.ones(8, device=device))
    x = torch.zeros((1, 8, 8, 12), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="C % 8"):
        cb.conv3x3_bf16(x, torch.zeros((9, 12, 16), dtype=torch.bfloat16, device=device))
    args = fb.random_block(1, 8, 8, 24, 16, device)
    with pytest.raises(ValueError, match="multiples of 16"):
        fb.fused_bottleneck(*args)


# ---------------------------------------------------------------- the evaluator
def _metric_on(batches, device, precise, nms=0.4):
    from yolo_tpu_torch.metrics import mAPMetric

    metric = mAPMetric(num_classes=20, precise=precise, nms_threshold=nms)
    for pred, target, *mask in batches:
        metric.update(torch.from_numpy(pred).to(device), torch.from_numpy(target).to(device),
                      *mask)
    return metric.compute(), metric


@pytest.mark.parametrize("nms", [0.4, 1.1])
def test_fast_metric_on_card_equals_cpu(device, nms):
    """All 77 keys and every per-batch array of the fast path on CUDA tensors
    equal the fast path on CPU tensors; one NMS launch a batch."""
    from chip_smoke import eval_batches

    batches = eval_batches()
    before = kernels.LAUNCHES["yolo_nms"]
    got, got_m = _metric_on(batches, device, False, nms)
    assert kernels.LAUNCHES["yolo_nms"] == before + len(batches)
    ref, ref_m = _metric_on(batches, "cpu", False, nms)
    assert len(got) == 77 and got == ref
    for a, b in zip(got_m._chunks, ref_m._chunks):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("nms", [0.4, 1.1])
def test_precise_metric_on_card_equals_cpu(device, nms):
    """The precise path in float64 on the card (the NMS kernel's float64
    instantiation, one launch a batch) equals the precise path on the CPU,
    all 77 keys and every per-batch array."""
    from chip_smoke import eval_batches

    batches = eval_batches()
    before = kernels.LAUNCHES["yolo_nms_f64"]
    got, got_m = _metric_on(batches, device, True, nms)
    assert kernels.LAUNCHES["yolo_nms_f64"] == before + len(batches)
    ref, ref_m = _metric_on(batches, "cpu", True, nms)
    assert len(got) == 77 and got == ref
    for a, b in zip(got_m._chunks, ref_m._chunks):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_eval_decode_and_matching_on_card_equal_cpu(device):
    """With ``s_divisor`` on the card the decode divides truly, as on the
    CPU; the matcher's flags are equal on both devices."""
    from chip_smoke import eval_grids
    from yolo_tpu_torch.ops.decode import decode_ground_truth, decode_predictions
    from yolo_tpu_torch.ops.matching import match_detections_masked

    pred, target = (torch.from_numpy(a) for a in eval_grids(5, 16))
    out = {}
    for dev in ("cpu", device):
        div = torch.tensor(7.0, device=dev)
        dets = decode_predictions(pred.to(dev), 7, 2, 20, 0.01, s_divisor=div)
        gts = decode_ground_truth(target.to(dev), 7, 2, 20, s_divisor=div)
        masks = torch.stack([gts.valid, gts.valid & (gts.boxes[..., 2] < 0.3)])
        thr = torch.tensor([0.5 + 0.05 * i for i in range(10)], device=dev)
        out[str(dev)] = (*dets, *gts, *match_detections_masked(
            dets.boxes, dets.scores, dets.class_ids, dets.valid, gts.boxes, gts.class_ids,
            masks, thr))
    for a, b in zip(out["cpu"], out[str(device)]):
        assert torch.equal(a, b.cpu())


# ------------------------------------------------------------ CUDA graphs
GRAPH_ENGINES = ("default", "wino", "chain", "exact")


@pytest.fixture(scope="module")
def graph_stack():
    """A small model (2 blocks a stage, 64x64) on the card and its four
    serving engines: default int8, all 8 Winograd points, stage chains on
    every stage, the exact float32 forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from yolo_tpu_torch.inference import YOLOInference
    from yolo_tpu_torch.models import create_model
    from yolo_tpu_torch.serving import cuda_bottleneck as cb
    from yolo_tpu_torch.serving import winograd
    from yolo_tpu_torch.serving.engine import build_int8_predict, make_int8_engine_fn

    dev = torch.device("cuda")
    model = create_model("resnet", 20, 7, 2, device=dev, stage_sizes=(2, 2, 2, 2),
                         image_size=64, generator=torch.Generator(device=dev).manual_seed(0))
    r = np.random.default_rng(4)
    calib = torch.from_numpy(r.normal(size=(4, 64, 64, 3)).astype(np.float32)).to(dev)
    fn, q = build_int8_predict(model, [calib])
    wfn, wq = build_int8_predict(model, [calib], wino=winograd.valid_points((2, 2, 2, 2)))
    chain = make_int8_engine_fn(7, 2, 20, impl={f"layer{i}": cb.chain_int8 for i in range(1, 5)})
    return {"default": (fn, q), "wino": (wfn, wq), "chain": (chain, q),
            "exact": YOLOInference(model, dev, image_size=64)}


def _eager_and_graphed(stack, name, conf, nms):
    from yolo_tpu_torch.serving.graphs import GraphedPredict

    if name == "exact":
        engine = stack["exact"]
        return (lambda images: engine.predict_batch_arrays(images, conf, nms),
                GraphedPredict(engine.batch_fn(conf, nms), engine.device))
    fn, q = stack[name]
    eager = lambda images: fn(q, images, conf, nms)  # noqa: E731
    return eager, GraphedPredict(eager, q["stem"]["wq"].device)


def _images(seed, n):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.integers(0, 256, size=(n, 64, 64, 3), dtype=np.uint8)).cuda()


def _median_score(eager, images):
    return float(eager(images).scores.float().median())


def _counts():
    return Counter(kernels.LAUNCHES)


@pytest.mark.parametrize("name", GRAPH_ENGINES)
def test_graph_replay_equals_eager(graph_stack, name):
    """Each engine replayed from its graph equals its eager call bit for bit
    at batch 1 and 3; a replay on new images gives their eager result (no
    stale output); replays move no launch counter (they count at capture)."""
    eager, _ = _eager_and_graphed(graph_stack, name, -1e30, 2.0)
    conf = _median_score(eager, _images(20, 3))
    eager, graphed = _eager_and_graphed(graph_stack, name, conf, 0.4)
    for n in (1, 3):
        first, second = _images(21 + n, n), _images(31 + n, n)
        want = [t.clone() for t in eager(first)]
        got = graphed(first)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert 0 < int(want[3].sum()) < n * 98
        counts = _counts()
        want2 = [t.clone() for t in eager(second)]
        assert _counts() != counts  # an eager call counts its launches
        counts = _counts()
        got2 = graphed(second)
        torch.cuda.synchronize()
        assert _counts() == counts
        assert all(torch.equal(a, b) for a, b in zip(got2, want2))
        assert not torch.equal(want2[1], want[1])


def test_graphs_refuse_the_cpu(device):
    from yolo_tpu_torch.serving.graphs import GraphedPredict

    with pytest.raises(ValueError, match="needs a CUDA device"):
        GraphedPredict(lambda images: images, "cpu")


def test_new_thresholds_make_a_new_wrapper(graph_stack):
    """Thresholds are host values at capture: each (conf, nms) pair has its
    own wrapper, and each equals the eager call at its own thresholds."""
    images = _images(40, 3)
    eager, _ = _eager_and_graphed(graph_stack, "default", -1e30, 2.0)
    median = _median_score(eager, images)
    masks = []
    # IoU >= 0 holds for every pair: NMS at 0 keeps one candidate a class.
    for conf, nms in ((median, 0.4), (-1e30, 0.4), (median, 0.0)):
        eager, graphed = _eager_and_graphed(graph_stack, "default", conf, nms)
        want = [t.clone() for t in eager(images)]
        got = graphed(images)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        masks.append(want[3])
    assert not torch.equal(masks[0], masks[1]) and not torch.equal(masks[0], masks[2])


def test_batcher_over_graphs_equals_the_padded_bucket_call(graph_stack):
    """RequestBatcher (pinned staging, one copy to the card) over a
    GraphedPredict: each result equals an eager call on the same zero-padded
    bucket, bit for bit."""
    from yolo_tpu_torch.serving import RequestBatcher

    eager, _ = _eager_and_graphed(graph_stack, "default", -1e30, 2.0)
    conf = _median_score(eager, _images(50, 3))
    eager, graphed = _eager_and_graphed(graph_stack, "default", conf, 0.4)
    images = _images(51, 3).cpu().numpy()
    with RequestBatcher(graphed, (64, 64, 3), buckets=(4,), max_delay_ms=500.0,
                        dtype=np.uint8) as batcher:
        batcher.warmup()
        got = [f.result(timeout=60) for f in [batcher.submit(im) for im in images]]
    assert batcher.bucket_batches[4] == 1
    padded = np.zeros((4, 64, 64, 3), np.uint8)
    padded[:3] = images
    want = [t.cpu().numpy() for t in eager(torch.from_numpy(padded).cuda())]
    for i, g in enumerate(got):
        for a, w in zip(g, want):
            np.testing.assert_array_equal(a, w[i])


# ------------------------------------------------------------ spans in graphs
@pytest.fixture(scope="module")
def flagship_engine():
    """The full-width int8 engine (ResNet-50, 448x448) on the card, its
    median-score threshold and a uint8 batch of 16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from yolo_tpu_torch.models import create_model
    from yolo_tpu_torch.serving.engine import build_int8_predict

    dev = torch.device("cuda")
    model = create_model("resnet", 20, 7, 2, device=dev, image_size=448,
                         generator=torch.Generator(device=dev).manual_seed(0))
    r = np.random.default_rng(60)
    calib = torch.from_numpy(r.normal(size=(2, 448, 448, 3)).astype(np.float32)).to(dev)
    fn, q = build_int8_predict(model, [calib])
    del model
    images = torch.from_numpy(r.integers(0, 256, size=(16, 448, 448, 3), dtype=np.uint8))
    conf = float(fn(q, images.to(dev), -1e30, 2.0).scores.float().median())
    return fn, q, conf, images.pin_memory()


def _graph_nodes(monkeypatch, capture):
    """Nodes of every CUDA graph ``capture()`` makes (kept after capture and
    counted by the driver's ``cuGraphGetNodes``)."""
    import ctypes

    made, real = [], torch.cuda.CUDAGraph

    def kept_graph():
        g = real(keep_graph=True)
        made.append(g)
        return g

    monkeypatch.setattr(torch.cuda, "CUDAGraph", kept_graph)
    try:
        capture()
    finally:
        monkeypatch.setattr(torch.cuda, "CUDAGraph", real)
    driver = ctypes.CDLL("libcuda.so.1")
    counts = []
    for g in made:
        n = ctypes.c_size_t(0)
        assert driver.cuGraphGetNodes(ctypes.c_void_p(g.raw_cuda_graph()), None,
                                      ctypes.byref(n)) == 0
        counts.append(n.value)
    return counts


def test_graph_captured_with_tracing_off_has_the_plain_capture_nodes(flagship_engine,
                                                                     monkeypatch):
    """Tracing off: GraphedPredict's one graph has the nodes of the callable
    captured plainly. Tracing on: the plain graph has them too, and the
    traced graph two event-record nodes more for each span the callable
    records (the engine's max-pool)."""
    from yolo_tpu_torch.serving.graphs import GraphedPredict
    from yolo_tpu_torch.utils import tracing

    fn, q, conf, images = flagship_engine
    predict = lambda x: fn(q, x, conf, 0.4)  # noqa: E731
    static = images.cuda()

    def plain():
        predict(static)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            predict(static)
        return g

    def graphed():
        [t.cpu() for t in GraphedPredict(predict, "cuda")(images)]

    (want,) = _graph_nodes(monkeypatch, plain)
    tracing.disable()
    (off,) = _graph_nodes(monkeypatch, graphed)
    tracing.enable()
    try:
        plain_on, traced_on = _graph_nodes(monkeypatch, graphed)
    finally:
        tracing.disable()
        tracing.take()
    assert want > 60 and off == plain_on == want and traced_on == want + 2


def test_spans_inside_a_graph_are_timed_at_every_replay(flagship_engine):
    """A span around the whole captured call reads, at each read replay (one
    in READ_EVERY), within 5% of events around that call (images already on
    the card, so the call is a device copy and the replay); the engine's
    max-pool span nests in it; nothing is unread; launches = replays x the
    launches of one eager call. With the tracer turned off, the next call
    drops the traced graph and replays the plain one."""
    from yolo_tpu_torch.serving.graphs import GraphedPredict
    from yolo_tpu_torch.utils import tracing

    fn, q, conf, images = flagship_engine
    before = Counter(kernels.LAUNCHES)
    fn(q, images.cuda(), conf, 0.4)
    torch.cuda.synchronize()
    eager = kernels.LAUNCHES - before
    assert eager == {"yolo_quant_s2d": 1, "yolo_max_pool_int8": 1, "yolo_int8_conv": 58,
                     "yolo_nms": 1}

    def predict(x):
        with tracing.span("whole"):
            return fn(q, x, conf, 0.4)

    calls = 2 * tracing.READ_EVERY
    on_card = images.cuda()
    around = []
    tracing.take()
    tracing.enable()
    try:
        graphed = GraphedPredict(predict, "cuda")
        for _ in range(calls):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            # ~5 ms of spinning on the card first: its clock then starts after the host has
            # issued the call, so the events time the device's copy and replay, not the
            # host's issue time (a fixed ~0.2 ms, which the span never sees).
            torch.cuda._sleep(10_000_000)
            start.record()
            out = graphed(on_card)
            end.record()
            [t.cpu() for t in out]
            around.append(start.elapsed_time(end))
        taken = tracing.take()
    finally:
        tracing.disable()
    assert graphed.captures == 2 and graphed.replays == calls
    assert graphed.launches() == {k: calls * n for k, n in eager.items()}
    assert taken.unread == 0 and taken.dropped == 0
    replays = {s.id: s for s in taken.spans if s.name == "graphs.replay"}
    whole = {s.id: s for s in taken.spans if s.name == "whole" and s.replayed}
    pools = [s for s in taken.spans if s.name == "engine.max_pool" and s.replayed]
    assert len(replays) == calls and len(whole) == len(pools) == 2
    assert all(s.weight == tracing.READ_EVERY for s in [*whole.values(), *pools])
    assert all(p.parent in whole for p in pools)
    traced_calls = [k for k in range(calls) if (k + 1) % tracing.READ_EVERY == 0]
    for w, k in zip(sorted(whole.values(), key=lambda s: s.start_ns), traced_calls):
        assert replays[w.parent].start_ns == w.start_ns
        assert abs(w.device_ms - around[k]) <= 0.05 * around[k], (w, around)
    assert all(0 < p.device_ms < whole[p.parent].device_ms for p in pools)
    [t.cpu() for t in graphed(images)]
    assert graphed.captures == 2 and graphed.replays == calls + 1
    assert graphed._graphs[(tuple(images.shape), images.dtype)].traced is None
    assert graphed.launches() == {k: (calls + 1) * n for k, n in eager.items()}
    assert tracing.take().spans == []


def test_swin_shifted_block_matches_the_reference_on_a_fused_backend(device, monkeypatch):
    """One shifted Swin block at stage-1 widths (112x112 tokens, 128 channels,
    4 heads, window 7, batch 4) against ``portbench/references/swin-b-yolov1.py``:
    float32 (TF32 off) to float32's rounding; under bf16 autocast, forward and
    every gradient to bf16 noise between the fused and the written-out
    attention, and bit for bit to the reference's own fused call (the core
    its training steps run). The bf16 forward and backward run the attention kernels that
    ``window_attn_share.train`` reads (a fused SDPA backend, not the math
    fallback), and with the tracer off no span makes a CUDA event."""
    from portbench import harness, weights
    from portbench.references.detect import exact_float32
    from yolo_tpu_torch.models.backbones import SwinBlock
    from yolo_tpu_torch.models.layers import shift_mask
    from yolo_tpu_torch.utils import tracing

    ref = harness.load_file(harness.HERE / "references" / "swin-b-yolov1.py")
    kernels = harness.load_file(harness.HERE / "metrics" / "window_attn_share.train.py").KERNELS
    c, heads, side = 128, 4, 112
    block = SwinBlock(c, heads, 7, 3, 4, device=device)
    spec = [(n, tuple(p.shape), "bn_gamma" if n.endswith("norm1.weight") else
             "bias" if "table" in n else "default", 2500 if "table" in n else c)
            for n, p in block.named_parameters()]
    sd = weights.make(spec, 11, device)
    block.load_state_dict(sd)
    mask = shift_mask(side, side, 7, 3).to(device)
    params = {n: v.clone().requires_grad_(True) for n, v in sd.items()}

    def reference(x, fused):
        model = ref._Model({"window_size": 7}, params, fused=fused)
        x = x + model.attention(model.ln(x, "norm1"), "attn", heads, 3, mask)
        y = torch.nn.functional.gelu(model.linear(model.ln(x, "norm2"), "mlp.fc1"))
        return x + model.linear(y, "mlp.fc2")

    x = torch.randn(4, side, side, c, device=device, generator=torch.Generator(
        device=device).manual_seed(3), requires_grad=True)
    names = [n for n, _ in block.named_parameters()]
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(1))
    with exact_float32():
        for amp, fused, tol in ((False, False, 1e-4), (True, False, 3e-2), (True, True, 0.0)):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                with torch.autocast("cuda", dtype=torch.bfloat16, enabled=amp):
                    got = block(x, mask)
                g = torch.randn_like(got)
                got_grads = torch.autograd.grad(got, [x, *block.parameters()], g)
                torch.cuda.synchronize()
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=amp):
                want = reference(x, fused)
            want_grads = torch.autograd.grad(want, [x, *(params[n] for n in names)], g)
            for name, a, b in zip(["out", "x", *names], [got, *got_grads], [want, *want_grads]):
                gap = float((a.float() - b.float()).norm() / b.float().norm())
                assert gap <= (tol if name != "out" else tol / 3), (amp, fused, name, gap)
            if amp:
                attn = [e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and any(k in e.name for k in kernels)]
                assert len(attn) >= 2, "the bf16 attention ran no fused kernel"
    assert not tracing.enabled() and made == []
