"""HTTP service — the MATLAB Production Server endpoint equivalent.

The reference deploys `main(input)` as an MPS function on Azure Container
Apps and the dashboard POSTs to it (README.md:20-22,28;
radar_processing_with_azure.m:9). This is the framework-native server:
a persistent process holding one `RadarService` (compiled pipelines are
reused across requests — the expensive XLA trace happens once per
recording-shape bucket), exposed over stdlib HTTP:

    POST /process   {"processAnimalActivity": "yes"|"no"}  → step-status JSON
                    (the exact radar_processing_with_azure.m:95-99 contract)
    POST /classify  spectrogram image(s) → label + probability (the
                    reference's "AI classification through API calls",
                    README.md:20); body is raw PNG/JPEG bytes
                    (Content-Type: image/*) or JSON
                    {"image_b64": "..."} / {"images_b64": ["...", ...]}.
                    Requires the service to be started with a classifier
                    artifact (serve --classifier-artifact DIR).
    GET  /healthz   liveness + request counters
    GET  /          service info

Accelerator access is serialized through a lock (the GPU is a single
shared accelerator; the reference's MPS concurrency model — scale via
replicas, one request per worker, README.md:35-38 — maps to one in-flight
chain request per process). /classify goes further than the reference's
model can: concurrently-arriving requests are coalesced into ONE bucketed
device batch by serve/batcher.py (cross-request micro-batching), with a
bounded queue that answers 503 when full (backpressure) instead of
accumulating unbounded latency. Zero third-party dependencies.
"""

from __future__ import annotations

import concurrent.futures
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from fmcw_radar_processing_tpu.serve.handler import HandlerConfig, RadarService
from fmcw_radar_processing_tpu.utils.observe import log_event


class _Handler(BaseHTTPRequestHandler):
    service: RadarService = None  # type: ignore[assignment]
    classifier = None  # SpectrogramClassifier | None
    batcher = None  # serve.batcher.ClassifyBatcher | None
    lock: threading.Lock = None  # type: ignore[assignment]
    stats: dict = None  # type: ignore[assignment]
    # Counter updates happen on ThreadingHTTPServer worker threads; dict
    # `+=` is a non-atomic read-modify-write, so guard with a dedicated
    # lock (NOT the accelerator lock — counters must not serialize behind
    # a long-running chain request).
    stats_lock: threading.Lock = None  # type: ignore[assignment]

    def _count(self, error: bool = False) -> None:
        with self.stats_lock:
            self.stats["requests"] += 1
            if error:
                self.stats["errors"] += 1

    def _send(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            extra = {}
            if self.batcher is not None:
                extra["classify_batching"] = dict(self.batcher.stats)
            self._send(200, {"status": "ok", **self.stats, **extra})
        elif path == "/":
            endpoints = {"POST /process": "run the radar chain",
                         "GET /healthz": "liveness"}
            if self.classifier is not None:
                endpoints["POST /classify"] = (
                    "classify spectrogram image(s): "
                    f"classes {list(self.classifier.classes)}"
                )
            self._send(200, {
                "service": "fmcw-radar-processing-tpu",
                "endpoints": endpoints,
            })
        else:
            self._send(404, {"status": "error", "message": "not found"})

    def do_POST(self) -> None:  # noqa: N802
        path = self.path.split("?", 1)[0]
        if path == "/classify":
            self._do_classify()
            return
        if path != "/process":
            self._send(404, {"status": "error", "message": "not found"})
            return
        try:
            n = int(self.headers.get("Content-Length") or 0)
            request = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(request, dict):
                raise ValueError("request body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._send(400, {"status": "error",
                             "message": f"bad request: {e}"})
            return
        t0 = time.perf_counter()
        with self.lock:  # one in-flight request per process (see module doc)
            result = self.service.main(request)
        dt = round(time.perf_counter() - t0, 4)
        self._count(error=result.get("status") != "success")
        log_event("process_request", status=result.get("status"),
                  duration_s=dt, steps=len(result.get("steps", [])))
        # The reference's MPS endpoint returns its status JSON with HTTP 200
        # even on processing errors (the status field carries the outcome).
        self._send(200, result)

    def _do_classify(self) -> None:
        if self.classifier is None:
            self._send(503, {
                "status": "error",
                "message": "no classifier loaded "
                           "(start with serve --classifier-artifact DIR)",
            })
            return
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n)
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            if ctype.startswith("image/"):
                blobs = [body]
            else:
                import base64

                request = json.loads(body or b"{}")
                if not isinstance(request, dict):
                    raise ValueError("request body must be a JSON object")
                if "images_b64" in request:
                    blobs = [base64.b64decode(s) for s in request["images_b64"]]
                elif "image_b64" in request:
                    blobs = [base64.b64decode(request["image_b64"])]
                else:
                    raise ValueError(
                        "provide image bytes (Content-Type: image/*) or "
                        "JSON with image_b64 / images_b64"
                    )
            if not blobs:
                raise ValueError("no images in request")
        except (ValueError, json.JSONDecodeError) as e:
            self._send(400, {"status": "error", "message": f"bad request: {e}"})
            return
        t0 = time.perf_counter()
        try:
            import numpy as np

            # Decode on this request's thread (host CPU work, concurrent);
            # only the device forward goes through the batcher, which
            # coalesces concurrently-arriving requests into one bucketed
            # batch behind the accelerator lock (serve/batcher.py).
            imgs = np.stack(
                [self.classifier.decode_image_bytes(b) for b in blobs])
        except Exception as e:  # undecodable image, shape mismatch, ...
            with self.stats_lock:
                self.stats["errors"] += 1
            self._send(400, {"status": "error",
                             "message": f"classification failed: {e}"})
            return
        from fmcw_radar_processing_tpu.serve.batcher import QueueFullError

        try:
            if self.batcher is not None:
                predictions = self.batcher.classify(imgs, timeout=300.0)
            else:
                with self.lock:
                    predictions = self.classifier.classify(imgs)
        except QueueFullError as e:
            with self.stats_lock:
                self.stats["errors"] += 1
                self.stats["rejected"] = self.stats.get("rejected", 0) + 1
            # Bounded-queue backpressure: tell the client to back off /
            # retry against another replica instead of queueing unbounded.
            self._send(503, {"status": "error",
                             "message": f"overloaded: {e}"})
            return
        except concurrent.futures.TimeoutError:
            # Server-side overload (the future never resolved): 5xx so
            # client retry/backoff logic engages — NOT a bad request. The
            # orphaned batch still runs and is discarded; acceptable for
            # a 300 s pathological stall.
            with self.stats_lock:
                self.stats["errors"] += 1
            self._send(503, {"status": "error",
                             "message": "overloaded: classification timed "
                                        "out in queue"})
            return
        except Exception as e:
            with self.stats_lock:
                self.stats["errors"] += 1
            self._send(400, {"status": "error",
                             "message": f"classification failed: {e}"})
            return
        dt = round(time.perf_counter() - t0, 4)
        self._count()
        log_event("classify_request", images=len(blobs), duration_s=dt)
        self._send(200, {
            "status": "success",
            "classes": list(self.classifier.classes),
            "predictions": predictions,
        })

    def log_message(self, fmt: str, *args) -> None:
        pass


class RadarHttpService:
    """Threaded HTTP wrapper around RadarService; context-manager friendly."""

    def __init__(self, config: HandlerConfig | None = None,
                 port: int = 8060, host: str = "127.0.0.1",
                 service: RadarService | None = None,
                 classifier=None, classifier_artifact: str | None = None,
                 classify_queue_images: int = 256):
        svc = service or RadarService(config)
        if classifier is None and classifier_artifact:
            from fmcw_radar_processing_tpu.models.infer import (
                SpectrogramClassifier,
            )

            classifier = SpectrogramClassifier.load(classifier_artifact)
        accel_lock = threading.Lock()
        batcher = None
        if classifier is not None:
            from fmcw_radar_processing_tpu.serve.batcher import (
                ClassifyBatcher,
            )

            if hasattr(classifier, "warmup"):
                # Compile every batch bucket BEFORE serving: otherwise the
                # first coalesced batch of each size pays ~1 s trace+
                # compile inside a client's latency window.
                classifier.warmup()
            batcher = ClassifyBatcher(
                classifier, accel_lock=accel_lock,
                max_queue_images=classify_queue_images)
        handler = type("Handler", (_Handler,), {
            "service": svc,
            "classifier": classifier,
            "batcher": batcher,
            "lock": accel_lock,
            "stats": {"requests": 0, "errors": 0},
            "stats_lock": threading.Lock(),
        })
        self.service = svc
        self.classifier = classifier
        self.batcher = batcher
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}/"

    def start(self) -> "RadarHttpService":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.batcher is not None:
            self.batcher.stop()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def __enter__(self) -> "RadarHttpService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
