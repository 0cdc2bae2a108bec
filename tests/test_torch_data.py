"""The port's VOC pipeline against ``yolo_tpu.data`` on a synthetic VOC tree.

Both read the same files; for the same (seed, epoch, idx) the images and
targets must be EQUAL, not close: the code is numpy/cv2/PIL on both sides,
with the same generator draws in the same order. The cv2 path and the PIL
fallback are both checked (the fallback by hiding cv2 from both modules).
"""

from pathlib import Path

import numpy as np
import pytest

import yolo_tpu.data.transforms as jax_transforms
import yolo_tpu_torch.data.transforms as port_transforms
from yolo_tpu import data as jax_data
from yolo_tpu_torch import data as port_data

XML = ("<annotation><size><width>{w}</width><height>{h}</height><depth>3</depth></size>"
       "{objects}</annotation>")
OBJ = ("<object><name>{name}</name><bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin>"
       "<xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox></object>")


def make_voc_tree(root: Path, n_images: int = 4, seed: int = 0) -> Path:
    """VOCdevkit/VOC2007 and VOC2012 with seeded JPEGs, annotations (two to
    four objects each, one of an unknown class) and the trainval/train/val
    split lists the training CLI reads."""
    r = np.random.default_rng(seed)
    classes = ["dog", "cat", "person", "car", "bicycle", "unicorn"]
    for year in ("2007", "2012"):
        voc = root / "VOCdevkit" / f"VOC{year}"
        for sub in ("JPEGImages", "Annotations", "ImageSets/Main"):
            (voc / sub).mkdir(parents=True, exist_ok=True)
        ids = []
        for k in range(n_images):
            img_id = f"{year}_{k:06d}"
            ids.append(img_id)
            w, h = int(r.integers(200, 400)), int(r.integers(150, 300))
            from PIL import Image

            Image.fromarray(r.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                voc / "JPEGImages" / f"{img_id}.jpg")
            objects = ""
            for _ in range(int(r.integers(2, 5))):
                x0, y0 = int(r.integers(0, w - 20)), int(r.integers(0, h - 20))
                x1, y1 = int(r.integers(x0 + 10, w + 1)), int(r.integers(y0 + 10, h + 1))
                objects += OBJ.format(name=classes[int(r.integers(len(classes)))],
                                      x0=x0, y0=y0, x1=x1, y1=y1)
            (voc / "Annotations" / f"{img_id}.xml").write_text(
                XML.format(w=w, h=h, objects=objects))
        main = voc / "ImageSets" / "Main"
        for split, part in (("trainval", ids), ("train", ids[: n_images // 2 + 1]),
                            ("val", ids[n_images // 2 + 1:] or ids[:1])):
            (main / f"{split}.txt").write_text("\n".join(part) + "\n")
    return root


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    return make_voc_tree(tmp_path_factory.mktemp("voc"), n_images=6)


@pytest.fixture(params=["cv2", "pil"])
def image_path(request, monkeypatch):
    """Run on cv2 where it is installed, and on the PIL fallback with cv2 hidden."""
    if request.param == "pil":
        monkeypatch.setattr(jax_transforms, "_HAS_CV2", False)
        monkeypatch.setattr(port_transforms, "_cv2", lambda: None)
    elif not jax_transforms._HAS_CV2 or port_transforms._cv2() is None:
        pytest.skip("cv2 is not installed")
    return request.param


def test_parse_xml_and_encode_target_match(voc_root):
    for xml in sorted((voc_root / "VOCdevkit" / "VOC2007" / "Annotations").glob("*.xml")):
        boxes, cls, size = port_data.parse_voc_xml(xml)
        j_boxes, j_cls, j_size = jax_data.parse_voc_xml(xml)
        np.testing.assert_array_equal(boxes, j_boxes)
        assert (cls, size) == (j_cls, j_size)
        for S, B, C in ((7, 2, 20), (4, 3, 20)):
            np.testing.assert_array_equal(port_data.encode_target(boxes, cls, S, B, C),
                                          jax_data.encode_target(j_boxes, j_cls, S, B, C))


@pytest.mark.parametrize("normalize_host", [True, False])
def test_train_transform_matches(voc_root, image_path, normalize_host):
    jpgs = sorted((voc_root / "VOCdevkit" / "VOC2012" / "JPEGImages").glob("*.jpg"))
    for idx, jpg in enumerate(jpgs):
        image = port_transforms.load_image_rgb(str(jpg))
        np.testing.assert_array_equal(image, jax_transforms.load_image_rgb(str(jpg)))
        boxes, _, _ = port_data.parse_voc_xml(
            str(jpg).replace("JPEGImages", "Annotations").replace(".jpg", ".xml"))
        seed = (3, 1, idx)
        got, got_boxes = port_transforms.train_transform(
            image, boxes, np.random.default_rng(seed), (64, 80), normalize_host=normalize_host)
        want, want_boxes = jax_transforms.train_transform(
            image, boxes, np.random.default_rng(seed), (64, 80), normalize_host=normalize_host)
        assert got.dtype == want.dtype and got.shape == (64, 80, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_boxes, want_boxes)


def test_eval_transform_and_datasets_match(voc_root, image_path):
    kw = dict(target_size=(64, 64), normalize_host=False)
    port_train = port_data.create_voc_datasets([("2007", "trainval"), ("2012", "train")],
                                               root=voc_root, **kw)
    jax_train = jax_data.create_voc_datasets([("2007", "trainval"), ("2012", "train")],
                                             download=False, root=voc_root, **kw)
    port_val = port_data.create_voc_datasets([("2012", "val")], root=voc_root, augment=False,
                                             **kw)
    jax_val = jax_data.create_voc_datasets([("2012", "val")], download=False, root=voc_root,
                                           augment=False, **kw)
    assert isinstance(port_train, port_data.CombinedVOCDataset)
    assert len(port_train) == len(jax_train) and len(port_val) == len(jax_val)
    for port_ds, jax_ds in ((port_train, jax_train), (port_val, jax_val)):
        for epoch in (0, 2):
            port_ds.set_epoch(epoch)
            jax_ds.set_epoch(epoch)
            for idx in range(len(port_ds)):
                (pi, pt), (ji, jt) = port_ds[idx], jax_ds[idx]
                assert pi.dtype == ji.dtype == np.uint8
                np.testing.assert_array_equal(pi, ji)
                np.testing.assert_array_equal(pt, jt)


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batches_match_with_thread_workers(voc_root, drop_last):
    kw = dict(target_size=(48, 48), normalize_host=False)
    port_ds = port_data.create_voc_datasets([("2007", "trainval"), ("2012", "train")],
                                            root=voc_root, **kw)
    jax_ds = jax_data.create_voc_datasets([("2007", "trainval"), ("2012", "train")],
                                          download=False, root=voc_root, **kw)
    loaders = [port_data.DataLoader(port_ds, batch_size=4, shuffle=True, num_workers=3,
                                    drop_last=drop_last, seed=7, worker_type="thread"),
               jax_data.DataLoader(jax_ds, batch_size=4, shuffle=True, num_workers=3,
                                   drop_last=drop_last, seed=7, worker_type="thread")]
    assert len(loaders[0]) == len(loaders[1])
    for epoch in (1, 2):
        for loader in loaders:
            loader.set_epoch(epoch)
        batches = [list(loader) for loader in loaders]
        assert len(batches[0]) == len(batches[1]) == len(loaders[0])
        for (pi, pt), (ji, jt) in zip(*batches):
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(pt, jt)
    for loader in loaders:
        loader.close()


def test_pad_batch_and_dataset_errors(voc_root, tmp_path):
    images, targets = np.ones((3, 4, 4, 3), np.uint8), np.ones((3, 7, 7, 30), np.float32)
    pi, pt, n = port_data.pad_batch(images, targets, 5)
    assert n == 3 and pi.shape == (5, 4, 4, 3) and not pi[3:].any() and not pt[3:].any()
    with pytest.raises(FileNotFoundError):
        port_data.VOCDetectionYOLO(tmp_path, year="2007", image_set="train")
    with pytest.raises(FileNotFoundError):
        port_data.VOCDetectionYOLO(voc_root, year="2007", image_set="test")


def test_device_normalize_matches_host_normalize_and_keeps_its_constants():
    import torch

    images = np.random.default_rng(4).integers(0, 256, (2, 5, 6, 3), dtype=np.uint8)
    got = port_transforms.device_normalize(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), jax_transforms.normalize(images), rtol=1e-6,
                               atol=1e-6)
    # The (3,) scale and bias are made once per device, not copied on every
    # call (on a GPU, a copy from host memory waits for the queued work).
    constants = port_transforms._NORM_ON_DEVICE[torch.device("cpu")]
    port_transforms.device_normalize(torch.from_numpy(images[:1]))
    assert port_transforms._NORM_ON_DEVICE[torch.device("cpu")] is constants
