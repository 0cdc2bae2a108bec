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
float32 FC copies) are not written. The AOT StableHLO artifact of the JAX
package has no torch reader and is not ported.
"""

from __future__ import annotations

import io
import json
from typing import Dict, Tuple

import numpy as np
import torch

from yolo_tpu_torch.serving.engine import DERIVED_KEYS

ENGINE_FORMAT_VERSION = 1
_NONE = "__none__"


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
