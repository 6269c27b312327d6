"""Service-level throughput benchmark (VERDICT r3 item 7).

The reference scales by Azure Container Apps replicas, one MPS request per
worker (/root/reference/README.md:35-38); this repo's analog is the
ThreadingHTTPServer in serve/http_service.py with one shared compiled
pipeline per process. This bench drives it over a real socket with N
concurrent clients and records requests/s + latency percentiles for:

  * POST /process  — the full MPS contract on a small stored recording
    (download → chain → STFT → 4 payload uploads per request), on BOTH
    algorithm profiles: fidelity (reference-literal) and production
    (the promoted throughput point — VERDICT r4 item 4a);
  * POST /classify — spectrogram PNG bytes → SmallCNN prediction, with
    cross-request micro-batching (serve/batcher.py): concurrent requests
    coalesce into one bucketed device batch (VERDICT r4 item 4b); the
    recorded row includes how much coalescing happened.

The jit cache is shared across server threads (chain requests serialize
on the accelerator lock — same model as one MPS worker per replica), so
concurrency measures queueing + host overhead on top of compute, not
recompiles.

The server runs in this process, on threads: one JAX process uses the card.

Run: python bench_serving.py [--record]   # --record writes
     chiprun_out/serving.json
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import sys
import tempfile
import time
import urllib.request


def _post(url: str, body: bytes, ctype: str = "application/json",
          timeout: float = 300.0):
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": ctype}, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        payload = json.loads(r.read())
    return time.perf_counter() - t0, payload


def _drive(url: str, bodies, workers: int, total: int, ctype: str):
    """total requests over a worker pool; returns (req/s, p50_ms, p95_ms)."""
    import numpy as np

    lat = []
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        futs = [ex.submit(_post, url, bodies[i % len(bodies)], ctype)
                for i in range(total)]
        for f in futs:
            dt, payload = f.result()
            status = payload.get("status")
            if status not in (None, "success"):
                raise RuntimeError(f"request failed: {payload}")
            lat.append(dt)
    wall = time.perf_counter() - t0
    lat_ms = np.asarray(sorted(lat)) * 1e3
    return (total / wall, float(np.percentile(lat_ms, 50)),
            float(np.percentile(lat_ms, 95)))


def main() -> int:
    record = "--record" in sys.argv
    import jax
    import numpy as np

    from fmcw_radar_processing_tpu.config import (
        RadarConfig,
        default_device_config,
    )
    from fmcw_radar_processing_tpu.io.raw_format import write_recording
    from fmcw_radar_processing_tpu.io.synth import (
        SyntheticTarget,
        synthesize_recording,
    )
    from fmcw_radar_processing_tpu.serve.handler import HandlerConfig
    from fmcw_radar_processing_tpu.serve.http_service import RadarHttpService

    cfg = RadarConfig.create(default_device_config())
    frames = int(os.environ.get("BENCH_SERVING_FRAMES", "64"))
    workers = int(os.environ.get("BENCH_SERVING_WORKERS", "8"))
    total = int(os.environ.get("BENCH_SERVING_REQUESTS", "64"))

    tmp = tempfile.mkdtemp(prefix="fmcw_serving_bench_")
    blob = os.path.join(tmp, "blob")
    work = os.path.join(tmp, "work")
    os.makedirs(blob)
    os.makedirs(work)
    rec = synthesize_recording(
        cfg, frames, (SyntheticTarget(range_m=6.0, doppler_bin_offset=2),),
        seed=0)
    write_recording(os.path.join(blob, "radar_data"), rec)

    # Classifier: randomly-initialized SmallCNN (serving cost is identical
    # to a trained one; this bench measures the service, not accuracy).
    from fmcw_radar_processing_tpu.models.infer import SpectrogramClassifier
    from fmcw_radar_processing_tpu.models.vgg import SmallCNN

    shape = (64, 64, 3)
    params = SmallCNN().init(
        jax.random.PRNGKey(0), np.zeros((1, *shape), np.float32),
        train=False)["params"]
    clf = SpectrogramClassifier("small", params, shape, ("calf", "human"))

    # One PNG body through the real chain's renderer.
    from fmcw_radar_processing_tpu.pipeline.recording import RadarPipeline
    from fmcw_radar_processing_tpu.pipeline.spectrogram_image import (
        render_spectrogram_png,
    )

    out = RadarPipeline(cfg).process_recording(
        rec.rx1_pair(), rec.calib_pair(0, cfg.nts))
    png_path = os.path.join(tmp, "spec.png")
    render_spectrogram_png(
        png_path, out.spectrogram_times, out.spectrogram_linear_freqs,
        out.spectrogram_psd_db, size=(300, 200))
    png = open(png_path, "rb").read()

    rows = []
    process_body = [json.dumps({"processAnimalActivity": "no"}).encode()]
    # r5 (VERDICT r4 item 4a): /process measured on BOTH algorithm
    # profiles. The r4 artifact only recorded the fidelity profile
    # (reference-literal hop-1 / next-pow-2 STFT); production() is the
    # repo's own promoted throughput point and is what `serve --profile
    # production` runs.
    for profile in ("fidelity", "production"):
        hc = HandlerConfig(fdata="radar_data", workdir=work,
                           storage_spec=f"local:{blob}", profile=profile)
        with RadarHttpService(hc, port=0) as srv:
            _post(srv.url + "process", b"{}")  # warm the jit cache
            rps, p50, p95 = _drive(srv.url + "process", process_body,
                                   workers, total, "application/json")
            row = {"endpoint": "process", "profile": profile,
                   "workers": workers, "requests": total,
                   "frames_per_recording": frames,
                   "requests_per_s": round(rps, 2),
                   "p50_ms": round(p50, 1), "p95_ms": round(p95, 1)}
            rows.append(row)
            print(json.dumps(row), flush=True)

    # r5 (VERDICT r4 item 4b): /classify with cross-request micro-batching
    # (serve/batcher.py) — concurrent requests coalesce into one bucketed
    # device batch; healthz reports how much coalescing happened.
    hc = HandlerConfig(fdata="radar_data", workdir=work,
                       storage_spec=f"local:{blob}")
    with RadarHttpService(hc, classifier=clf, port=0) as srv:
        _post(srv.url + "classify", png, "image/png")  # warm
        rps, p50, p95 = _drive(srv.url + "classify", [png], workers,
                               total, "image/png")
        with urllib.request.urlopen(srv.url + "healthz", timeout=60) as r:
            health = json.loads(r.read())
        bstats = health.get("classify_batching", {})
        served = max(bstats.get("batches", 1), 1)
        row = {"endpoint": "classify", "workers": workers,
               "requests": total,
               "requests_per_s": round(rps, 2),
               "p50_ms": round(p50, 1), "p95_ms": round(p95, 1),
               "batches": bstats.get("batches"),
               "batched_images": bstats.get("batched_images"),
               "max_batch": bstats.get("max_batch"),
               "mean_batch": round(
                   bstats.get("batched_images", 0) / served, 2)}
        rows.append(row)
        print(json.dumps(row), flush=True)

    if record:
        artifact = {
            "device_kind": jax.devices()[0].device_kind,
            "methodology": (
                f"{workers} concurrent clients, {total} requests per "
                "endpoint over a real socket against ThreadingHTTPServer; "
                "shared jit cache; /process serializes on the accelerator "
                "lock (one MPS worker per replica, README.md:35-38 "
                "analog) and is measured on both the fidelity and "
                "production algorithm profiles; /classify coalesces "
                "concurrent requests into bucketed device batches "
                "(serve/batcher.py) with a bounded 503-on-full queue; "
                "warmup request excluded"),
            "rows": rows,
        }
        os.makedirs("chiprun_out", exist_ok=True)
        with open("chiprun_out/serving.json", "w") as f:
            json.dump(artifact, f, indent=2)
        print("wrote chiprun_out/serving.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
