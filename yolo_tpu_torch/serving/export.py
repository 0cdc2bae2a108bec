"""Serialized int8 engine artifacts: save and load the calibrated q-params.

Port of the ``.npz`` half of yolo_tpu/serving/export.py, in the same format,
so an artifact written by either package loads in the other:

- one ``.npz`` whose keys are '/'-joined tree paths; list levels (the 4
  stages, the blocks of a stage) use integer segments plus a ``__len__``
  entry;
- a None leaf (an identity block's ``downsample``, a transition block's
  ``rx``) is a ``__none__`` sentinel key;
- bfloat16 arrays are stored as uint16, with their true dtype under
  ``dtypes`` in the ``__meta__`` JSON entry, which also pins the format
  version and the model geometry (S, B, num_classes).

The derived device-side keys of ``engine.to_device`` (packed kernel weights,
float32 FC copies) are not written.

The AOT artifact (:func:`save_compiled_engine`, :func:`load_compiled_engine`)
freezes the whole served graph, not just its parameters: the int8 forward,
decode and NMS with the thresholds, batch and image size baked in, recorded
by ``torch.export`` into one ``.pt2`` with the q-params as the program's
buffers. The four kernels are custom ops in it (``serving/library.py``).
The JAX package's AOT artifact is StableHLO in an ``.npz``, which torch
cannot run: re-export from its q-params (``serve --engine X.npz
--save-compiled Y.pt2``).
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from yolo_tpu_torch.serving import library  # noqa: F401  (registers the ops a .pt2 calls)
from yolo_tpu_torch.serving.engine import DERIVED_KEYS

ENGINE_FORMAT_VERSION = 1
AOT_FORMAT_VERSION = 1
_NONE = "__none__"
#: The AOT artifact's meta JSON, an extra file of the ``.pt2`` archive.
AOT_META = "yolo_tpu_torch_aot.json"
#: Wire dtypes an AOT artifact takes: raw resized RGB, or normalized images.
_WIRE = {"uint8": torch.uint8, "float32": torch.float32}


def _to_numpy(t) -> Tuple[np.ndarray, bool]:
    """(array, is_bfloat16); bfloat16 comes back as its uint16 bit pattern."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    return np.asarray(t), False


def _flatten(prefix: str, node, out: Dict[str, np.ndarray], dtypes: Dict[str, str]):
    if node is None:
        out[prefix + "/" + _NONE] = np.zeros((), np.int8)
    elif isinstance(node, dict):
        for k, v in node.items():
            if k not in DERIVED_KEYS:
                _flatten(f"{prefix}/{k}" if prefix else k, v, out, dtypes)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(f"{prefix}/{i}", v, out, dtypes)
        out[prefix + "/__len__"] = np.asarray(len(node), np.int64)
    else:
        out[prefix], bf16 = _to_numpy(node)
        if bf16:
            dtypes[prefix] = "bfloat16"


def save_engine(path, q: Dict, S: int, B: int, num_classes: int) -> None:
    """Write the quantized engine params + geometry to ``path`` (.npz)."""
    flat: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    _flatten("", q, flat, dtypes)
    meta = {"format_version": ENGINE_FORMAT_VERSION, "S": S, "B": B,
            "num_classes": num_classes, "dtypes": dtypes}
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    with open(path, "wb") as fh:
        fh.write(buf.getvalue())


def _unflatten(flat: Dict[str, torch.Tensor]):
    if set(flat) == {_NONE}:
        return None
    if "__len__" in {k.split("/", 1)[0] for k in flat}:
        n = int(flat["__len__"])
        return [
            _unflatten({k.split("/", 1)[1]: v for k, v in flat.items()
                        if k.split("/", 1)[0] == str(i)})
            for i in range(n)
        ]
    groups: Dict = {}
    for k, v in flat.items():
        head, _, rest = k.partition("/")
        if rest:
            groups.setdefault(head, {})[rest] = v
        else:
            groups[head] = v
    return {k: (_unflatten(v) if isinstance(v, dict) else v) for k, v in groups.items()}


def load_engine(path) -> Tuple[Dict, Dict]:
    """Read a saved engine: (q-params as CPU tensors, meta).

    Raises ValueError for a file without ``__meta__`` or of a newer format.
    """
    if _aot_meta_name(_archive_names(path)) is not None:
        raise ValueError(f"{path} is an AOT engine artifact (.pt2): load it with "
                         f"load_compiled_engine (serve --compiled)")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    meta_raw = flat.pop("__meta__", None)
    if meta_raw is None:
        raise ValueError(f"{path} is not a yolo-tpu engine artifact")
    meta = json.loads(bytes(meta_raw.tobytes()).decode())
    if meta.get("format_version", 0) > ENGINE_FORMAT_VERSION:
        raise ValueError(
            f"engine artifact format {meta['format_version']} is newer than"
            f" this build supports ({ENGINE_FORMAT_VERSION})"
        )
    bf16 = {k for k, dt in meta.get("dtypes", {}).items() if dt == "bfloat16"}
    tensors = {}
    for k, v in flat.items():
        if k in bf16:
            tensors[k] = torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
        else:
            tensors[k] = torch.from_numpy(np.array(v))
    return _unflatten(tensors), meta


# --------------------------------------------------------------------------
# AOT artifact: the served graph itself, recorded by torch.export.
# --------------------------------------------------------------------------

def register_detections_serialization() -> None:
    """``torch.export.save`` needs a serialized name for the Detections
    output (the counterpart of JAX's ``_register_detections_serialization``);
    registering twice is a no-op."""
    from torch.utils import _pytree

    from yolo_tpu_torch.ops.decode import Detections

    if Detections not in _pytree.SUPPORTED_NODES:
        _pytree._register_namedtuple(
            Detections, serialized_type_name="yolo_tpu_torch.ops.decode.Detections")


class _PackedView(NamedTuple):
    """A weight the program holds only packed: ``wq`` (HWIO, or fc1's (K,
    Cout)) as a strided view of the kernel's ``wk`` (Cout, Kpad), which
    holds the same int8 values K-contiguous."""

    wk: str
    shape: Tuple[int, ...]


class _EngineProgram(torch.nn.Module):
    """The default int8 engine through the custom ops, closed over the
    thresholds, with the q-params as buffers named by their tree paths.

    A weight is held once, in the form the engine reads: on CUDA ``wk``
    (``wq`` becomes a view of it), and the float32 ``wf`` of a bfloat16 FC
    weight instead of ``w``."""

    def __init__(self, q: Dict, S: int, B: int, num_classes: int,
                 conf_threshold: float, nms_threshold: float):
        from yolo_tpu_torch.serving.engine import make_int8_engine_fn
        from yolo_tpu_torch.serving.library import aot_conv, aot_impl, aot_nms

        super().__init__()
        self.fn = make_int8_engine_fn(S, B, num_classes, impl=aot_impl(), nms_fn=aot_nms,
                                      conv=aot_conv)
        self.conf_threshold, self.nms_threshold = float(conf_threshold), float(nms_threshold)
        self.layout = self._hold("", q)

    def _hold(self, path: str, node):
        if node is None:
            return None
        if isinstance(node, list):
            return [self._hold(f"{path}/{i}", v) for i, v in enumerate(node)]
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                key = f"{path}/{k}" if path else k
                if k == "w" and "wf" in node:
                    continue
                out[k] = (_PackedView(f"{path}/wk", tuple(v.shape)) if k == "wq" and "wk" in node
                          else self._hold(key, v))
            return out
        self.register_buffer(path, node)
        return path

    def _tree(self, node):
        if node is None:
            return None
        if isinstance(node, list):
            return [self._tree(v) for v in node]
        if isinstance(node, dict):
            return {k: self._tree(v) for k, v in node.items()}
        if isinstance(node, _PackedView):
            wk = getattr(self, node.wk)
            dims = node.shape[:-1]
            strides = [int(np.prod(dims[i + 1:], dtype=np.int64)) for i in range(len(dims))]
            return torch.as_strided(wk, node.shape, (*strides, wk.shape[1]))
        return getattr(self, node)

    def forward(self, images: torch.Tensor):
        return self.fn(self._tree(self.layout), images, self.conf_threshold,
                       self.nms_threshold)


def _device_of(q: Dict) -> torch.device:
    s_img = q["s_img"]
    return s_img.device if isinstance(s_img, torch.Tensor) else torch.device("cpu")


def export_compiled_engine(
    q: Dict,
    S: int,
    B: int,
    num_classes: int,
    *,
    batch_size: int,
    conf_threshold: float,
    nms_threshold: float,
    image_size: int = 448,
    dtype=np.uint8,
    platforms: Optional[Tuple[str, ...]] = None,
) -> Tuple[torch.export.ExportedProgram, Dict]:
    """The recording half of :func:`save_compiled_engine`: (the
    ``torch.export`` program, its meta), nothing written."""
    from yolo_tpu_torch.serving.engine import to_device
    from yolo_tpu_torch.serving.winograd import wino_points_of

    device = _device_of(q)
    if platforms is not None and tuple(platforms) != (device.type,):
        raise ValueError(
            f"save_compiled_engine: platforms={tuple(platforms)}, but the port's AOT "
            f"artifact holds the program for one device type, the q-params' "
            f"({device.type!r})")
    wino = wino_points_of(q)
    if wino:
        raise ValueError(f"save_compiled_engine: the AOT artifact serves the default engine; "
                         f"the Winograd convs {wino} have no custom op")
    wire = np.dtype(dtype).name
    if wire not in _WIRE:
        raise ValueError(f"save_compiled_engine: dtype must be uint8 or float32, got {wire}")
    program = _EngineProgram(to_device(q, device), S, B, num_classes, conf_threshold,
                             nms_threshold)
    images = torch.zeros((int(batch_size), int(image_size), int(image_size), 3),
                         dtype=_WIRE[wire], device=device)
    register_detections_serialization()
    exported = torch.export.export(program, (images,), strict=False)
    meta = {
        "aot_format_version": AOT_FORMAT_VERSION,
        "S": S,
        "B": B,
        "num_classes": num_classes,
        "batch_size": int(batch_size),
        "image_size": int(image_size),
        "conf_threshold": float(conf_threshold),
        "nms_threshold": float(nms_threshold),
        "dtype": wire,
        "platforms": [device.type],
        "torch_version": torch.__version__,
    }
    return exported, meta


def write_compiled_engine(path, exported: torch.export.ExportedProgram, meta: Dict) -> None:
    """The writing half of :func:`save_compiled_engine`: one ``.pt2``, the
    meta JSON an extra file of it."""
    torch.export.save(exported, path, extra_files={AOT_META: json.dumps(meta)})


def save_compiled_engine(
    path,
    q: Dict,
    S: int,
    B: int,
    num_classes: int,
    *,
    batch_size: int,
    conf_threshold: float,
    nms_threshold: float,
    image_size: int = 448,
    dtype=np.uint8,
    platforms: Optional[Tuple[str, ...]] = None,
) -> None:
    """Freeze the full serving graph, not just its parameters, to one ``.pt2``.

    The default int8 engine (``engine.make_int8_engine_fn``
    with the stem front, every int8 conv and NMS as the custom ops of
    ``serving/library.py``) is recorded by ``torch.export`` at the fixed
    ``(batch_size, image_size, image_size, 3)`` input with the thresholds
    baked in, and written with ``torch.export.save``; the q-params are the
    program's buffers. ``q`` as ``engine.to_device`` returns it (or the
    plain q-params, which are moved and packed here), on the device the
    program is for.

    ``dtype=np.uint8`` bakes the raw-RGB wire format (normalization in the
    graph); ``np.float32`` feeds normalized images. ``platforms`` is the
    one device type of ``q`` (the default): unlike the JAX package's
    artifact, which lowers one module per platform (TPU and CPU by default)
    into one file, the port's holds the program for one device type. The
    chain and Winograd hooks have no op: q-params with Winograd convs are
    refused. JAX's ``nms_fn`` has no counterpart: the NMS is the kernel's.
    """
    write_compiled_engine(path, *export_compiled_engine(
        q, S, B, num_classes, batch_size=batch_size, conf_threshold=conf_threshold,
        nms_threshold=nms_threshold, image_size=image_size, dtype=dtype, platforms=platforms))


def _archive_names(path) -> list:
    """The entries of a zip archive (``.pt2`` and ``.npz`` are both zips), or []."""
    try:
        with zipfile.ZipFile(path) as archive:
            return archive.namelist()
    except zipfile.BadZipFile:
        return []


def _aot_meta_name(names) -> Optional[str]:
    """The entry of an AOT artifact's meta JSON among ``names``, or None."""
    return next((n for n in names if n.rsplit("/", 1)[-1] == AOT_META), None)


def _read_aot_meta(path) -> Dict:
    names = _archive_names(path)
    name = _aot_meta_name(names)
    if name is None:
        if "__stablehlo__.npy" in names:
            raise ValueError(
                f"{path} is the JAX package's AOT artifact (StableHLO), which torch cannot "
                f"run: re-export it from its q-params (serve --engine X.npz "
                f"--save-compiled Y.pt2)")
        raise ValueError(f"{path} is not a yolo-tpu AOT engine artifact")
    with zipfile.ZipFile(path) as archive:
        return json.loads(archive.read(name).decode())


def load_compiled_engine(path, device=None) -> Tuple[Callable, Dict]:
    """Load an AOT artifact: ``(predict(images) -> Detections, meta)``.

    ``predict`` runs the recorded program (``ep.module()``) on ``device``
    (default: the device type it was exported for; a CUDA program saved on
    another card index is moved), with TF32 off for the FC products, as the
    live engine runs them. It issues no host synchronization, so
    ``GraphedPredict`` can capture it. The batch size, image size, wire
    dtype and thresholds are fixed at export and recorded in ``meta``.

    Raises ValueError for a plain ``.npz`` engine artifact, for the JAX
    package's StableHLO artifact (torch cannot run StableHLO), for a newer
    format, and for a device type the artifact was not exported for.
    """
    from yolo_tpu_torch.serving.engine import _exact_float32_matmul

    meta = _read_aot_meta(path)
    if meta.get("aot_format_version", 0) > AOT_FORMAT_VERSION:
        raise ValueError(
            f"AOT artifact format {meta['aot_format_version']} is newer than"
            f" this build supports ({AOT_FORMAT_VERSION})"
        )
    device = torch.device(device if device is not None else meta["platforms"][0])
    if device.type not in meta["platforms"]:
        raise ValueError(
            f"{path} holds a program for {meta['platforms']}, not for {device.type!r}: "
            f"re-export it on {device.type!r} (the port's AOT artifact holds one device type)")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    register_detections_serialization()
    exported = torch.export.load(path)
    held = next(iter(exported.state_dict.values())).device
    if held != device:
        exported = torch.export.passes.move_to_device_pass(exported, device)
    program = exported.module()

    def predict(images):
        with torch.inference_mode(), _exact_float32_matmul():
            return program(images)

    return predict, meta
