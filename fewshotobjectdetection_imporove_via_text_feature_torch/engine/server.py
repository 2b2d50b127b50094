"""HTTP detection service over a predictor: ``DefaultPredictor`` (a live
model) or ``engine.export.ServingPredictor`` (a serving artifact).

Counterpart of the JAX package's ``engine/server.py``, on the standard
library's ``ThreadingHTTPServer`` with numpy and PIL.

Endpoints:
    GET  /healthz   liveness and the count of requests served
    GET  /meta      the input contract (resize bounds, class names if known)
    POST /detect    body: an encoded image (anything PIL decodes: JPEG,
                    PNG, ...); response: JSON {"boxes": [[x1, y1, x2, y2],
                    ...] (original-image coordinates), "scores": [...],
                    "classes": [...], "class_names": [...] when known}

Errors: 400 (the body does not decode), 404 (no such route), 413 (the body
is over ``max_body_bytes``), 422 (the predictor's contract error, a
``ValueError``, such as an artifact without the image's bucket), 500
(anything else, with a JSON body). Images decode with PIL, EXIF
orientation applied, to RGB, and reach the predictor in its BGR
convention (``preprocess_single_image``).

Dynamic batching (``max_batch > 1``): concurrent requests queue into a
dispatcher thread that groups up to ``max_batch`` images arriving within
``batch_window_ms`` into one ``predict_batch`` call; an error of that call
reaches every waiter of the batch. ``max_batch=1`` runs requests one at a
time under a lock.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np

__all__ = ["DetectionServer"]

_SHUTDOWN = object()


class DetectionServer:
    """Serve ``predictor`` (any callable: BGR uint8 HxWx3 -> dict with
    numpy "boxes"/"scores"/"classes") over HTTP.

    ``port=0`` binds an ephemeral port (read ``.port`` after construction).
    ``start()`` runs in a daemon thread; ``serve_forever()`` blocks.
    ``max_batch > 1`` requires a predictor with ``predict_batch``.
    """

    def __init__(
        self,
        predictor,
        host: str = "127.0.0.1",
        port: int = 8080,
        class_names: Optional[Sequence[str]] = None,
        meta: Optional[dict] = None,
        max_batch: int = 1,
        batch_window_ms: float = 5.0,
        max_body_bytes: int = 64 << 20,
    ):
        self._predictor = predictor
        self._lock = threading.Lock()
        self._served = 0
        self._class_names = list(class_names) if class_names else None
        self._meta = dict(meta or {})
        self._max_batch = int(max_batch)
        self._window_s = batch_window_ms / 1e3
        self._max_body = int(max_body_bytes)
        if self._max_batch > 1 and not hasattr(predictor, "predict_batch"):
            raise ValueError(
                f"max_batch={max_batch} needs a predictor with "
                "predict_batch (DefaultPredictor has one; a batch-1 "
                "serving artifact does not)"
            )
        self._queue: "queue.Queue" = queue.Queue()
        self._dispatcher: Optional[threading.Thread] = None
        if self._max_batch > 1:
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, daemon=True
            )
            self._dispatcher.start()
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            # a stalled/byte-dripping client must not pin a handler thread
            # forever
            timeout = 60.0

            # stdlib default logs every request to stderr; route through
            # our logger-free counter instead (the access log is the
            # caller's concern)
            def log_message(self, fmt, *args):  # noqa: D401
                pass

            def _json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(
                        200, {"status": "ok", "requests_served": outer._served}
                    )
                elif self.path == "/meta":
                    meta = dict(outer._meta)
                    meta["max_batch"] = outer._max_batch
                    if outer._class_names:
                        meta["class_names"] = outer._class_names
                    self._json(200, meta)
                else:
                    self._json(404, {"error": f"no route {self.path!r}"})

            def do_POST(self):
                if self.path != "/detect":
                    self._json(404, {"error": f"no route {self.path!r}"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                if n > outer._max_body:
                    # reject before reading: an oversized body must not
                    # be buffered into memory at all
                    self._json(
                        413,
                        {"error": f"body of {n} bytes exceeds the "
                         f"{outer._max_body}-byte limit"},
                    )
                    return
                try:
                    raw = self.rfile.read(n)
                    from PIL import Image, ImageOps

                    img = Image.open(io.BytesIO(raw))
                    # EXIF orientation, as the mapper's decode applies it:
                    # phone-camera JPEGs would otherwise be detected
                    # sideways
                    img = ImageOps.exif_transpose(img).convert("RGB")
                    bgr = np.asarray(img, np.uint8)[:, :, ::-1]
                except Exception as e:  # undecodable payload
                    self._json(400, {"error": f"could not decode image: {e}"})
                    return
                try:
                    det = outer._run(bgr)
                except ValueError as e:
                    # predictor contract errors (e.g. an artifact missing
                    # the needed bucket) are the client's 422, not a 500
                    self._json(422, {"error": str(e)})
                    return
                except Exception as e:  # anything else: an honest 500
                    # (a raw socketserver traceback closes the connection
                    # mid-request — curl would see a reset, no error body)
                    self._json(
                        500, {"error": f"{type(e).__name__}: {e}"}
                    )
                    return
                classes = np.asarray(det["classes"]).tolist()
                payload = {
                    "boxes": np.asarray(det["boxes"], np.float64).tolist(),
                    "scores": np.asarray(det["scores"], np.float64).tolist(),
                    "classes": classes,
                }
                if outer._class_names:
                    payload["class_names"] = [
                        outer._class_names[c]
                        if 0 <= c < len(outer._class_names)
                        else str(c)
                        for c in classes
                    ]
                self._json(200, payload)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------- request paths --
    def _run(self, bgr: np.ndarray) -> dict:
        if self._max_batch <= 1:
            with self._lock:
                det = self._predictor(bgr)
                self._served += 1
            return det
        slot = {"image": bgr, "event": threading.Event(),
                "result": None, "error": None}
        self._queue.put(slot)
        slot["event"].wait()
        if slot["error"] is not None:
            raise slot["error"]
        return slot["result"]

    def _dispatch_loop(self):
        while True:
            first = self._queue.get()
            if first is _SHUTDOWN:
                return
            slots = [first]
            deadline = time.monotonic() + self._window_s
            while len(slots) < self._max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    # re-post so the loop exits after finishing this batch
                    self._queue.put(_SHUTDOWN)
                    break
                slots.append(nxt)
            try:
                dets = self._predictor.predict_batch(
                    [s["image"] for s in slots]
                )
                for s, d in zip(slots, dets):
                    s["result"] = d
                self._served += len(slots)
            except Exception as e:
                for s in slots:
                    s["error"] = e
            for s in slots:
                s["event"].set()

    # ----------------------------------------------------------- control --
    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self):
        self._httpd.serve_forever()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._dispatcher is not None:
            self._queue.put(_SHUTDOWN)
            self._dispatcher.join(timeout=5)
