"""Service handler — the `main(input)` endpoint of the reference
(radar_processing_with_azure.m:9-100), re-built as a storage-agnostic
Python service.

Request/response contract (kept byte-compatible so existing dashboard
clients keep working):

    input:  {"processAnimalActivity": "yes"|"no"}       (:16-22)
    output: {"status": "success"|"error",
             "message": str,
             "steps": [{"step", "status", "message"}, ...]}   (:95-99)

Steps: Read Files → Radar Processing → Upload JSON, each try/except'd with
early-return on failure (:38-45, :56-66). The reference's stray
non-comment line at :67 (a latent syntax error) is fixed as per its
obvious intent (SURVEY Appendix A #7). Improvements over the reference's
failure story (SURVEY §5.3): storage operations retry with exponential
backoff, and every step records wall-clock duration.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

from fmcw_radar_processing_tpu.config import RadarConfig
from fmcw_radar_processing_tpu.io.raw_format import load_recording_for_chain
from fmcw_radar_processing_tpu.io.storage import Storage, get_storage
from fmcw_radar_processing_tpu.pipeline.recording import RadarPipeline
from fmcw_radar_processing_tpu.pipeline.spectrogram_image import (
    render_spectrogram_png,
)
from fmcw_radar_processing_tpu.utils.jsonio import write_json


@dataclasses.dataclass
class HandlerConfig:
    fdata: str = "radar_data"  # base recording name (:15 of blob reader)
    workdir: str = "."
    storage_spec: str | None = None
    retries: int = 3
    pretty_json: bool = True  # reference 'PrettyPrint' fidelity; False = fast/compact
    retry_backoff_s: float = 0.5
    upload: bool = True
    # Algorithm profile: "fidelity" (default — the reference's literal
    # hop-1 / nfft=2^nextpow2 STFT and f32 artifacts, byte-parity with a
    # MATLAB run) or "production" (AlgorithmConfig.production(): 256-pt
    # STFT bucket + bf16 intensity + three-TF32-pass matmuls; payload
    # shapes differ from MATLAB).
    profile: str = "fidelity"


def _retry(fn: Callable[[], Any], retries: int, backoff: float):
    last: Exception | None = None
    for attempt in range(retries):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — step status captures it
            last = e
            if attempt + 1 < retries:
                time.sleep(backoff * (2**attempt))
    raise last  # type: ignore[misc]


class RadarService:
    """Stateful service: storage + compiled pipelines, reused across requests."""

    def __init__(self, config: HandlerConfig | None = None,
                 storage: Storage | None = None):
        self.config = config or HandlerConfig()
        self.storage = storage or get_storage(self.config.storage_spec)
        self._pipelines: dict[tuple, RadarPipeline] = {}

    # -------------------- steps --------------------

    def _download(self) -> str:
        """Step 1: fetch <fdata>.xml + <fdata>.raw.bin
        (read_data_from_blob_storage.m:18-27)."""
        base = os.path.join(self.config.workdir, self.config.fdata)
        for ext in (".xml", ".raw.bin"):
            name = self.config.fdata + ext
            _retry(
                lambda n=name, e=ext: self.storage.get(n, base + e),
                self.config.retries,
                self.config.retry_backoff_s,
            )
        return base

    def _upload_json(self, path: str) -> int:
        if not self.config.upload:
            return 0
        name = os.path.basename(path)
        _retry(
            lambda: self.storage.put(path, name, "application/json"),
            self.config.retries,
            self.config.retry_backoff_s,
        )
        return 1

    def _upload_png(self, path: str) -> int:
        if not self.config.upload:
            return 0
        name = os.path.basename(path)
        _retry(
            lambda: self.storage.put(path, name, "image/png"),
            self.config.retries,
            self.config.retry_backoff_s,
        )
        return 1

    def _pipeline_for(self, cfg: RadarConfig) -> RadarPipeline:
        key = (cfg.device, cfg.algorithm)
        if key not in self._pipelines:
            self._pipelines[key] = RadarPipeline(cfg, filename=self.config.fdata)
        return self._pipelines[key]

    def _process(self, basepath: str, activity: bool) -> tuple[list[str], int]:
        """Step 2: the signal chain + JSON/PNG export + upload
        (radar_processing.m:195-436 'no' / :440-607 'yes').

        Returns (written artifact paths, number actually uploaded)."""
        raw, calib, device = load_recording_for_chain(basepath)
        if self.config.profile == "production":
            from fmcw_radar_processing_tpu.config import AlgorithmConfig

            cfg = RadarConfig.create(device, AlgorithmConfig.production())
        else:
            cfg = RadarConfig.create(device)
        pipe = self._pipeline_for(cfg)
        written: list[str] = []
        uploaded = 0
        if not activity:
            out = pipe.process_recording(raw, calib)
            for name, payload in out.payloads.items():
                path = os.path.join(self.config.workdir, name)
                write_json(path, payload, pretty=self.config.pretty_json)
                uploaded += self._upload_json(path)
                written.append(path)
            png = os.path.join(self.config.workdir, "spectrogram.png")
            # The reference renders surf(T, F, psd) — the LINEAR-frequency
            # dB PSD (radar_processing.m:331-340); only the JSON payload is
            # log-frequency rescaled. The classifier's input images depend
            # on this distinction.
            render_spectrogram_png(
                png,
                out.spectrogram_times,
                out.spectrogram_linear_freqs,
                out.spectrogram_psd_db,
            )
            uploaded += self._upload_png(png)  # :348
            written.append(png)
        else:
            for batch in pipe.process_activity(raw, calib):
                path = os.path.join(self.config.workdir, batch.filename)
                write_json(path, batch.payload, pretty=self.config.pretty_json)
                uploaded += self._upload_json(path)  # :593
                written.append(path)
        return written, uploaded

    # -------------------- the endpoint --------------------

    def main(self, request: dict | None = None) -> dict:
        """The `main(input)` endpoint (radar_processing_with_azure.m:9)."""
        request = request or {}
        flag = str(request.get("processAnimalActivity", "no")).lower()  # :16-22
        activity = flag == "yes"
        steps: list[dict] = []

        def fail(step: str, exc: Exception, message: str) -> dict:
            steps.append(
                {"step": step, "status": "error", "message": str(exc)}
            )
            return {"status": "error", "message": message, "steps": steps}

        t0 = time.perf_counter()
        try:
            basepath = self._download()
            steps.append({
                "step": "Read Files",
                "status": "success",
                "message": "Files downloaded from storage successfully.",
                "duration_s": round(time.perf_counter() - t0, 4),
            })
        except Exception as e:  # :38-45
            return fail("Read Files", e, "Failed at reading files from blob storage.")

        t1 = time.perf_counter()
        try:
            written, uploaded = self._process(basepath, activity)
            steps.append({
                "step": "Radar Processing",
                "status": "success",
                "message": "Radar data processed successfully.",
                "artifacts": [os.path.basename(w) for w in written],
                "duration_s": round(time.perf_counter() - t1, 4),
            })
        except Exception as e:  # :56-66
            return fail("Radar Processing", e, "Failed at radar processing step.")

        # Step 3 reports what actually happened: uploads run inside the
        # processing step (as in the reference, :67-85, quirk #7 fixed),
        # so this step truthfully summarizes them rather than claiming an
        # unconditional success.
        if self.config.upload:
            steps.append({
                "step": "Upload JSON",
                "status": "success",
                "message": f"Uploaded {uploaded} artifact(s) to storage.",
            })
        else:
            steps.append({
                "step": "Upload JSON",
                "status": "skipped",
                "message": "Upload disabled; artifacts written locally only.",
            })
        return {
            "status": "success",
            "message": "All steps completed successfully.",
            "steps": steps,
        }


def main(request: dict | None = None, config: HandlerConfig | None = None) -> dict:
    """Module-level convenience endpoint (one-shot service)."""
    return RadarService(config).main(request)
