"""HTTP serving front end: a stdlib JSON endpoint over the RequestBatcher.

Port of yolo_tpu/serving/server.py: many concurrent clients, one device,
requests coalesced into fixed-bucket batches (on the card, one replayed
CUDA graph a bucket). Dependency-free apart from PIL (http.server):

- ``POST /predict`` with an image file body (JPEG/PNG/anything PIL
  decodes). The image is resized to the engine's input size on the host
  (the dataset's eval transform, data/transforms.py::eval_transform) and
  enqueued on the shared ``RequestBatcher``; the response is JSON
  ``{"detections": [{"class_id", "class_name", "score", "box"}]}`` with
  boxes in normalized cxcywh (the schemas.BoundingBox convention), sorted
  by score. Concurrent requests ride the same engine batch
  (ThreadingHTTPServer: one thread per connection, all feeding one batcher).
- ``GET /healthz`` -> ``{"status": "ok", "batches_dispatched": N,
  "images_served": N}`` for load balancers.

Errors: 400 for a bad Content-Length, an empty body or an image PIL cannot
decode; 404 for an unknown path; 413 for a body over ``max_body_bytes``;
500 when the engine fails or does not answer within ``request_timeout_s``.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from yolo_tpu_torch.data.voc import VOC_CLASSES
from yolo_tpu_torch.serving.batcher import RequestBatcher


class _Listener(ThreadingHTTPServer):
    # socketserver's default backlog of 5 drops connections from 16 or more
    # concurrent clients; each dropped SYN costs its client a 1-3 s retry.
    request_queue_size = 128


def detections_to_json(det, class_names: Optional[Sequence[str]]) -> list:
    """One image's Detections (numpy, no batch dim) -> JSON list.

    Keeps the valid (NMS-kept) rows; boxes stay normalized cxcywh, the
    convention of schemas.BoundingBox and the predict CLI's output.
    """
    boxes = np.asarray(det.boxes)
    scores = np.asarray(det.scores)
    class_ids = np.asarray(det.class_ids)
    valid = np.asarray(det.valid)
    out = []
    for k in np.flatnonzero(valid):
        cid = int(class_ids[k])
        entry = {
            "class_id": cid,
            "score": float(scores[k]),
            "box": [float(v) for v in boxes[k]],
        }
        if class_names is not None and 0 <= cid < len(class_names):
            entry["class_name"] = class_names[cid]
        out.append(entry)
    out.sort(key=lambda e: -e["score"])
    return out


class YOLOServer:
    """Own the HTTP listener + batcher; ``with YOLOServer(...) as s: ...``.

    Args:
        predict: batch callable ``(images (n, H, W, C) host tensor) ->
            Detections`` (thresholds already closed over), e.g. a
            ``serving.graphs.GraphedPredict``.
        image_size: engine input edge (requests are resized to this).
        dtype: wire dtype the engine expects (uint8 = normalize on the device).
        host/port: bind address; port 0 picks a free port (see ``.port``).
        buckets/max_delay_ms: RequestBatcher knobs.
        class_names: id -> name mapping for the JSON payload.
        request_timeout_s: how long a request waits for its batch.
        max_body_bytes: larger bodies are refused (413) without being read.
    """

    def __init__(
        self,
        predict: Callable,
        image_size: int = 448,
        *,
        dtype=np.uint8,
        host: str = "127.0.0.1",
        port: int = 0,
        buckets: Tuple[int, ...] = (1, 4, 16),
        max_delay_ms: float = 2.0,
        class_names: Optional[Sequence[str]] = VOC_CLASSES,
        request_timeout_s: float = 60.0,
        max_body_bytes: int = 32 * 1024 * 1024,
    ):
        self.image_size = int(image_size)
        self._dtype = np.dtype(dtype)
        self._class_names = class_names
        self._timeout = float(request_timeout_s)
        self.max_body_bytes = int(max_body_bytes)
        self.batcher = RequestBatcher(
            predict,
            (self.image_size, self.image_size, 3),
            buckets=buckets,
            max_delay_ms=max_delay_ms,
            dtype=self._dtype,
        )
        server = self  # close over for the handler

        class _Handler(BaseHTTPRequestHandler):
            # Silence per-request stderr lines; stats live at /healthz.
            def log_message(self, *args):
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path != "/healthz":
                    return self._reply(404, {"error": "unknown path"})
                self._reply(
                    200,
                    {
                        "status": "ok",
                        "batches_dispatched": server.batcher.batches_dispatched,
                        "images_served": server.batcher.images_served,
                    },
                )

            def do_POST(self):
                if self.path != "/predict":
                    return self._reply(404, {"error": "unknown path"})
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    return self._reply(400, {"error": "bad Content-Length"})
                if length <= 0:
                    return self._reply(400, {"error": "empty body"})
                if length > server.max_body_bytes:
                    return self._reply(
                        413,
                        {
                            "error": "body too large "
                            f"(max {server.max_body_bytes} bytes)"
                        },
                    )
                raw = self.rfile.read(length)
                try:
                    image = server._decode(raw)
                except Exception as exc:  # noqa: BLE001 — client error
                    return self._reply(400, {"error": f"bad image: {exc}"})
                try:
                    det = server.batcher.submit(image).result(
                        timeout=server._timeout
                    )
                except Exception as exc:  # noqa: BLE001 — engine error
                    return self._reply(500, {"error": str(exc)})
                self._reply(
                    200,
                    {
                        "detections": detections_to_json(
                            det, server._class_names
                        )
                    },
                )

        try:
            self._http = _Listener((host, port), _Handler)
        except OSError:
            # Bind failed (e.g. port in use): don't leak the batcher's
            # already-running worker thread.
            self.batcher.close()
            raise
        self.host, self.port = self._http.server_address[:2]
        self._thread = threading.Thread(
            target=self._http.serve_forever, daemon=True
        )
        self._thread.start()

    def _decode(self, raw: bytes) -> np.ndarray:
        from PIL import Image

        from yolo_tpu_torch.data.transforms import eval_transform, normalize

        image = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
        resized = eval_transform(
            image, (self.image_size, self.image_size), normalize_host=False
        )
        if self._dtype == np.uint8:
            return resized
        return normalize(resized).astype(self._dtype)

    def warmup(self) -> None:
        """Run (on the card: capture) every bucket before taking traffic."""
        self.batcher.warmup()

    def close(self) -> None:
        self._http.shutdown()
        self._http.server_close()
        self._thread.join()
        self.batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
