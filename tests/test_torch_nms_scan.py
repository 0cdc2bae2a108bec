"""The NMS and stem-front kernels' algorithms, restated in numpy, against the references.

Neither CUDA kernel runs on the CPU, so this file restates each one's
decomposition step for step and holds it against the plain versions:

- NMS (``csrc/nms.cu``): a 64-bit sort key (class, then score descending;
  -0.0 ties 0.0) and a rank by counting; the boxes scattered to sorted order;
  class-segment ends as bit words; the suppression mask a row and a 32-bit
  word at a time, only over the row's class segment (unwritten words keep a
  garbage pattern, so a read of one would show); the one-warp scan over
  blocks of 32 sorted positions (later words take only the kept rows whose
  class segment runs past the block). Its keep masks must equal
  ``cuda_nms.nms_reference`` and JAX's ``batched_nms`` bit for bit. JAX's
  ``batched_nms`` keeps a valid candidate whose score is -inf when nothing
  suppresses it, where the TPU kernel (pallas_nms.py:74) and the port never
  keep one; decode never marks a -inf score valid, so the JAX comparison
  masks such candidates out.
- Stem front (``csrc/quant_s2d.cu``): the 3 x 256 table built with the
  kernel's float32 formula, then the units of 4 output pixels (vector path
  for warps of 32 whole, aligned units with contiguous output; byte path
  for the rest) written into a buffer;
  every output byte must be written exactly once and equal
  ``cuda_stem.quant_s2d_reference`` bit for bit, at scales chosen so that
  table values land on .5 rounding ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import CASES
from yolo_tpu.ops.decode import Detections as JDetections
from yolo_tpu.ops.nms import batched_nms as j_batched_nms
from yolo_tpu_torch.data.transforms import _NORM_BIAS, _NORM_SCALE
from yolo_tpu_torch.ops import cuda_nms
from yolo_tpu_torch.serving import cuda_stem

F32 = np.float32
INELIGIBLE = np.uint64(2**64 - 1)
GARBAGE = 0xA5A5A5A5
FULL = 0xFFFFFFFF


# ---------------------------------------------------------------- NMS
def sort_keys(scores, cls, valid):
    """The kernel's keys: (class ^ 2^31) << 32 | ~ordered(score); eligible
    (valid, score > -inf) or INELIGIBLE."""
    s = scores.astype(F32)
    bits = np.where(s == 0, np.uint32(0), s.view(np.uint32))
    ordered = np.where(bits & np.uint32(0x80000000), ~bits, bits | np.uint32(0x80000000))
    cls_bits = cls.astype(np.int32).view(np.uint32) ^ np.uint32(0x80000000)
    key = (cls_bits.astype(np.uint64) << np.uint64(32)) | (~ordered.astype(np.uint32)).astype(
        np.uint64)
    eligible = valid.astype(bool) & (s > -np.inf)
    return np.where(eligible, key, INELIGIBLE), eligible


def _iou_hits(sx1, sy1, sx2, sy2, sarea, a, bs, t, eps):
    """IoU(a, b) >= t for sorted candidates b in ``bs``, in the kernel's op order."""
    iw = np.maximum(F32(0), np.minimum(sx2[bs], sx2[a]) - np.maximum(sx1[bs], sx1[a]))
    ih = np.maximum(F32(0), np.minimum(sy2[bs], sy2[a]) - np.maximum(sy1[bs], sy1[a]))
    inter = iw * ih
    uni = (sarea[bs] + sarea[a]) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        if eps == 0:
            iou = np.where(uni == 0, F32(0), inter / np.where(uni == 0, F32(1), uni))
        else:
            iou = inter / (uni + eps)
    return iou >= t


def kernel_nms_np(boxes, scores, cls, valid, t, eps):
    """csrc/nms.cu's keep mask (n, K), restated step for step."""
    t, eps = F32(t), F32(eps)
    n, K = scores.shape
    keep = np.zeros((n, K), bool)
    for img in range(n):
        cx, cy, w, h = (boxes[img, :, k].astype(F32) for k in range(4))
        hw, hh = w * F32(0.5), h * F32(0.5)
        x1, y1, x2, y2, area = cx - hw, cy - hh, cx + hw, cy + hh, w * h
        key, eligible = sort_keys(scores[img], cls[img], valid[img])
        idx = np.arange(K)
        before = (key[None, :] < key[:, None]) | (
            (key[None, :] == key[:, None]) & (idx[None, :] < idx[:, None]))
        rank = before.sum(axis=1)
        M = int(eligible.sum())
        order = np.full(M, -1)
        order[rank[eligible]] = idx[eligible]
        assert (order >= 0).all(), "ranks of eligible candidates must be a permutation"
        sx1, sy1, sx2, sy2, sarea = (v[order] for v in (x1, y1, x2, y2, area))
        scls = cls[img][order]
        Wm = (M + 31) // 32
        # Segment ends as words.
        end_bits = np.zeros(Wm * 32, bool)
        r = np.arange(M)
        end_bits[:M] = (r == M - 1) | (scls[np.minimum(r + 1, M - 1)] != scls)
        ends = [int(sum(1 << b for b in range(32) if end_bits[32 * w_ + b])) for w_ in range(Wm)]
        # The mask, a row at a time, words outside the row's segment unwritten.
        mask = np.full((M, Wm), GARBAGE, np.int64)
        for a in range(M):
            wd = a >> 5
            e = ends[wd] & ((FULL << (a & 31)) & FULL)
            while e == 0:
                wd += 1
                e = ends[wd]
            last = (wd << 5) + (e & -e).bit_length() - 1
            bs = np.arange(a + 1, last + 1)
            hits = _iou_hits(sx1, sy1, sx2, sy2, sarea, a, bs, t, eps)
            for w_ in range(a >> 5, (last >> 5) + 1):
                word = 0
                for b, hit in zip(bs, hits):
                    if hit and w_ * 32 <= b < w_ * 32 + 32:
                        word |= 1 << (b - 32 * w_)
                mask[a, w_] = word
            mask[a, (last >> 5) + 1:] = 0
        # The scan.
        removed = [0] * 32
        for wb in range(Wm):
            cur = removed[wb]
            r0 = wb << 5
            count = min(32, M - r0)
            diag = [int(mask[r0 + j, wb]) if j < count else 0 for j in range(32)]
            assert GARBAGE not in diag[:count]
            for j in range(32):
                if not (cur >> j) & 1:
                    cur |= diag[j]
            kept = ~cur & (FULL if count == 32 else (1 << count) - 1)
            # Only kept rows whose segment runs past the block's last segment end.
            high = ends[wb].bit_length() - 1
            spread = kept & (0 if high == 31 else (FULL << (high + 1)) & FULL)
            removed[wb] = cur
            for lane in range(wb + 1, Wm):
                for j in range(32):
                    if (spread >> j) & 1:
                        word = int(mask[r0 + j, lane])
                        assert word != GARBAGE, "the scan read a word the kernel never writes"
                        removed[lane] |= word
        for i in range(K):
            if eligible[i]:
                ri = int(rank[i])
                keep[img, i] = not (removed[ri >> 5] >> (ri & 31)) & 1
    return keep


def _random_case(seed, n, K, kind):
    """Seeded detections. The last row is all invalid, the one before it all -inf."""
    r = np.random.default_rng(seed)
    boxes = r.uniform(0.05, 0.95, size=(n, K, 4)).astype(F32)
    boxes[..., 2:] *= 0.4
    scores = r.uniform(size=(n, K)).astype(F32)
    cls = r.integers(0, 4, size=(n, K)).astype(np.int32)
    if kind == "ties":
        pick = r.integers(0, min(4, K), size=(n, K, 1)).repeat(4, 2)
        boxes = np.take_along_axis(boxes, pick, 1)
        levels = np.array([0.0, -0.0, 0.5, -np.inf], F32)
        scores = levels[r.integers(0, 4, size=(n, K))]
    elif kind == "single_class":
        cls[:] = 0
    elif kind == "identical":
        boxes[:] = F32([0.5, 0.5, 0.3, 0.2])
        cls[:] = 7
    valid = r.uniform(size=(n, K)) < 0.8
    valid[-1] = False
    scores[-2] = -np.inf
    return boxes, scores, cls, valid


def _jax_keep(boxes, scores, cls, valid, t, eps):
    d = JDetections(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls),
                    jnp.asarray(valid & (scores > -np.inf)))
    return np.asarray(j_batched_nms(d, t, eps=eps).valid)


def _check_nms(arrays, t, eps):
    boxes, scores, cls, valid = (np.asarray(a) for a in arrays)
    got = kernel_nms_np(boxes, scores, cls, valid, t, eps)
    twin = cuda_nms.nms_reference(
        *(torch.from_numpy(np.array(a)) for a in (boxes, scores, cls, valid)),
        float(F32(t)), float(F32(eps))).numpy()
    np.testing.assert_array_equal(got, twin, err_msg="restatement vs nms_reference")
    np.testing.assert_array_equal(got, _jax_keep(boxes, scores, cls, valid, t, eps),
                                  err_msg="restatement vs JAX batched_nms")
    return got


@pytest.mark.parametrize("eps", [1e-6, 0.0])
@pytest.mark.parametrize("t", [0.4, 0.5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_equals_references_on_the_ops_cases(case, t, eps):
    _check_nms(CASES[case](), t, eps)


@pytest.mark.parametrize("eps", [1e-6, 0.0])
@pytest.mark.parametrize("t", [0.4, 0.5])
@pytest.mark.parametrize("kind", ["uniform", "ties", "single_class", "identical"])
@pytest.mark.parametrize("K", [1, 31, 98, 162, 392, 1024])
def test_scan_equals_references(K, kind, t, eps):
    n = 4 if K <= 162 else 3
    keep = _check_nms(_random_case(K + len(kind), n, K, kind), t, eps)
    assert not keep[-2:].any()  # the all -inf row and the all-invalid row keep nothing
    if kind == "identical" and K > 1:
        # One box repeated: each image keeps exactly its best eligible candidate.
        assert (keep[:-2].sum(axis=1) == 1).all()


def test_nms_cases_suppress():
    """The random cases do real work: some candidates kept, some suppressed."""
    boxes, scores, cls, valid = _random_case(3, 4, 392, "single_class")
    keep = kernel_nms_np(boxes, scores, cls, valid, 0.4, 1e-6)
    eligible = valid & (scores > -np.inf)
    assert 0 < keep.sum() < eligible.sum()


def test_sort_key_order():
    """Class first, then score descending, with -0.0 and 0.0 tied."""
    scores = np.array([0.5, -0.0, 0.0, -1.0, np.inf, 0.25, 0.5], F32)
    cls = np.array([1, 1, 1, 1, 1, 0, -3], np.int32)
    key, eligible = sort_keys(scores, cls, np.ones(7, bool))
    assert eligible.all()
    assert key[1] == key[2]
    order = sorted(range(7), key=lambda i: (int(key[i]), i))
    assert order == [6, 5, 4, 0, 1, 2, 3]
    key, eligible = sort_keys(np.array([-np.inf, 0.1], F32), np.zeros(2, np.int32),
                              np.array([True, False]))
    assert not eligible.any() and (key == INELIGIBLE).all()


# ---------------------------------------------------------------- stem front
def stem_table(s_img):
    """(3, 256) int8: the kernel's table, by its formula in float32."""
    u = np.arange(256, dtype=F32)
    v = (u[None, :] * _NORM_SCALE.astype(F32)[:, None]) + _NORM_BIAS.astype(F32)[:, None]
    q = np.rint(v / F32(s_img))
    return np.clip(q, -127, 127).astype(np.int8)


def _quantize_f32(v, s_img):
    return np.clip(np.rint(v.astype(F32) / F32(s_img)), -127, 127).astype(np.int8)


def stem_units_np(images, s_img, base=0):
    """csrc/quant_s2d.cu's output, unit by unit: (out, writes per byte, vector units)."""
    n, h, w, _ = images.shape
    ho, wo = h // 2, w // 2
    per_row = -(-wo // 4)
    u = np.arange(n * ho * per_row)
    row = u // per_row
    j0 = (u - row * per_row) * 4
    in0 = (2 * row * w + 2 * j0) * 3
    in1 = in0 + w * 3
    out_at = (row * wo + j0) * 12
    pixels = np.minimum(4, wo - j0)
    esize, align = (1, 8) if images.dtype == np.uint8 else (4, 16)
    addr = (base + in0 * esize) | (base + in1 * esize)
    whole = (pixels == 4) & (addr % align == 0) & (out_at % 16 == 0)
    # A warp (32 consecutive units) takes the vector path only if all its
    # units are whole and aligned and its output bytes are contiguous.
    pad = -len(u) % 32
    warp_ok = np.concatenate([whole, np.zeros(pad, bool)]).reshape(-1, 32).all(axis=1)
    out_pad = np.concatenate([out_at, np.zeros(pad, out_at.dtype)]).reshape(-1, 32)
    warp_ok &= (out_pad == out_pad[:, :1] + 48 * np.arange(32)).all(axis=1)
    vec = np.repeat(warp_ok, 32)[:len(u)]

    flat = images.reshape(-1)
    if images.dtype == np.uint8:
        table = stem_table(s_img)
        value = lambda at, c: table[c, flat[at]]  # noqa: E731
    else:
        value = lambda at, c: _quantize_f32(flat[at], s_img)  # noqa: E731
    out = np.zeros(n * ho * wo * 12, np.int8)
    writes = np.zeros(out.shape, np.int32)
    # Vector units: output byte o is pixel j = o // 12, row p = o % 12 // 6,
    # element e = 6j + o % 6 of that row, channel e % 3.
    for o in range(48):
        j, p, e = o // 12, o % 12 // 6, 6 * (o // 12) + o % 6
        src = (in1 if p else in0)[vec] + e
        out[out_at[vec] + o] = value(src, e % 3)
        np.add.at(writes, out_at[vec] + o, 1)
    # Byte units: pixel j < pixels, row p, element e of the pixel's 6.
    for j in range(4):
        sel = ~vec & (j < pixels)
        for p in range(2):
            for e in range(6):
                src = (in1 if p else in0)[sel] + 6 * j + e
                dst = out_at[sel] + 12 * j + 6 * p + e
                out[dst] = value(src, e % 3)
                np.add.at(writes, dst, 1)
    return out.reshape(n, ho, wo, 12), writes, int(vec.sum())


def _tie_scales(count=3):
    """Scales s for which some table value v has v / s exactly on k + 0.5."""
    v = ((np.arange(256, dtype=F32)[None, :] * _NORM_SCALE.astype(F32)[:, None])
         + _NORM_BIAS.astype(F32)[:, None]).ravel()
    found = []
    for vi in v[::37]:
        for k in (-100, -7, 0, 3, 60):
            s = F32(vi / F32(k + 0.5))
            if s > 0 and F32(vi) / s == F32(k + 0.5):
                found.append(float(s))
                break
        if len(found) == count:
            return found
    raise AssertionError("no tie scale found")


def _ties(s_img):
    v = ((np.arange(256, dtype=F32)[None, :] * _NORM_SCALE.astype(F32)[:, None])
         + _NORM_BIAS.astype(F32)[:, None])
    q = v / F32(s_img)
    return int((q - np.floor(q) == F32(0.5)).sum())


SCALES = [0.0173, 2.0 / 127] + _tie_scales()


@pytest.mark.parametrize("s_img", SCALES)
def test_stem_table_equals_reference(s_img):
    s = torch.tensor(s_img, dtype=torch.float32)
    # Every byte value in every channel, as a 1 x 2 x 256 image pair of rows.
    u = np.arange(256, dtype=np.uint8)
    images = np.stack([u, u, u], axis=-1)[None, None].repeat(2, axis=1)  # (1, 2, 256, 3)
    ref = cuda_stem.quant_s2d_reference(torch.from_numpy(images), s).numpy()
    # out[0, 0, J, (p*2+q)*3 + c] = table[c, 2J + q]
    table = stem_table(s_img)
    got = np.stack([table[c, 2 * np.arange(128) + q] for p in range(2) for q in range(2)
                    for c in range(3)], axis=-1)
    np.testing.assert_array_equal(got, ref[0, 0])
    if s_img not in (0.0173, 2.0 / 127):
        assert _ties(s_img) > 0, "the scale must put some table value on a .5 tie"


STEM_SHAPES = [(1, 448, 448), (3, 18, 10), (2, 64, 64), (2, 6, 2), (1, 4, 6), (2, 10, 14),
               (1, 2, 18), (3, 8, 16)]


@pytest.mark.parametrize("base", [0, 8, 3])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("shape", STEM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_stem_units_equal_reference(shape, dtype, base):
    r = np.random.default_rng(sum(shape) + base)
    n, h, w = shape
    if dtype == "uint8":
        images = r.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)
    else:
        images = r.normal(0, 1.5, size=(n, h, w, 3)).astype(F32)
    s_img = SCALES[-1]
    got, writes, n_vec = stem_units_np(images, s_img, base)
    assert (writes == 1).all(), "every output byte written exactly once"
    ref = cuda_stem.quant_s2d_reference(torch.from_numpy(images),
                                        torch.tensor(s_img, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(got, ref)
    units = n * (h // 2) * -(-(w // 2) // 4)
    if base == 0 and (w // 2) % 4 == 0:
        assert n_vec == units // 32 * 32  # aligned rows: every full warp takes the vector path
    assert n_vec <= units // 32 * 32
