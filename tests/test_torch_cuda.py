"""The CUDA NMS kernel against its plain twin, on the card.

Marked ``cuda``: these tests need an NVIDIA GPU and nvcc, and skip without
them. Run them on the GPU machine with ``python -m pytest tests/test_torch_cuda.py``;
``chip_smoke.py`` covers the same ground at the slice's shapes.
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
