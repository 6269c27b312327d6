"""End-to-end recording pipelines — the accelerator equivalent of
``radar_processing('no')`` and ``radar_processing('yes')``.

Host/device split: the whole per-frame chain plus packing and STFT run as a
handful of jitted stages; the host only (a) reads back the slow-time valid
count to pick the STFT's nfft bucket — nfft is 2^nextpow2(signal length) in
the reference (radar_processing.m:273), an inherently data-dependent shape
that must be a compile-time constant under jit — and (b) assembles JSON
payloads from final arrays. Buckets are powers of two, so each recording
shape compiles at most once per bucket and the cache stays small.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from fmcw_radar_processing_tpu.config import RadarConfig
from fmcw_radar_processing_tpu.config.radar import next_pow2
from fmcw_radar_processing_tpu.dsp.stft import (
    StftOperator,
    log_frequency_rescale,
    psd_db,
    stft_frame_count,
)
from fmcw_radar_processing_tpu.pipeline.frame_chain import (
    FrameChainOutputs,
    make_frame_chain,
    pack_slow_time,
)
from fmcw_radar_processing_tpu.pipeline.payloads import (
    fft_snapshot_payload,
    range_fft_payload,
    range_speed_payload,
    spectrogram_payload,
)
from fmcw_radar_processing_tpu.utils.cplx import pair_abs, to_pair


def _normalize_raw(raw: np.ndarray, nts: int) -> np.ndarray:
    """Normalize any accepted raw layout to flat pair-rows [F, PN, 2·NTS].

    Accepted: complex [F, PN, NTS], real [F, PN, NTS], pair
    [F, PN, NTS, 2], or already-flat [F, PN, 2·NTS]. Disambiguation of the
    ndim-3 real case is by last-dim size against ``nts`` (a real ndim-3
    array whose last dim is 2·NTS is the flat layout, NOT a signal to
    pair-ify — that ambiguity previously crashed flat float input)."""
    raw = np.asarray(raw) if not isinstance(raw, jnp.ndarray) else raw
    if np.iscomplexobj(raw):
        raw = to_pair(np.asarray(raw))
    elif raw.ndim == 3 and raw.shape[-1] == nts:
        raw = to_pair(np.asarray(raw))  # real samples: imag = 0
    elif raw.ndim == 3 and raw.shape[-1] != 2 * nts:
        raise ValueError(
            f"ndim-3 raw last dim {raw.shape[-1]} is neither NTS={nts} "
            f"(samples) nor 2·NTS={2 * nts} (flat pair-rows)"
        )
    if raw.ndim == 4 and raw.shape[-1] == 2:
        raw = (raw.reshape(*raw.shape[:2], -1) if isinstance(raw, np.ndarray)
               else jnp.reshape(raw, (*raw.shape[:2], -1)))
    return raw


@dataclasses.dataclass
class RecordingOutputs:
    """Full-recording ('no') mode results (arrays host-side NumPy)."""

    waterfall: np.ndarray  # (K, F)
    target_range: np.ndarray  # (T, F) NaN-filled
    target_speed: np.ndarray  # (T, F)
    target_strength: np.ndarray  # (T, F)
    detected: np.ndarray  # (F,) bool
    spectrogram_times: np.ndarray  # (T_stft,)
    spectrogram_freqs: np.ndarray  # (1024,) log-spaced
    spectrogram_intensity: np.ndarray  # (1024, T_stft) dB
    # Linear-frequency dB PSD — what the reference's PNG renders
    # (surf(T, F, psd) at radar_processing.m:331-340, BEFORE the
    # log-frequency rescale that only the JSON consumes).
    spectrogram_linear_freqs: np.ndarray  # (nb,) uniform one-sided axis
    spectrogram_psd_db: np.ndarray  # (nb, T_stft) dB
    payloads: dict[str, dict]  # name -> payload dict (4 schemas)


@dataclasses.dataclass
class ActivityBatchOutput:
    """One activity-mode ('yes') batch spectrogram (radar_processing.m:444-607)."""

    batch: int  # 1-based batch number
    start_frame: int  # 1-based inclusive
    end_frame: int  # 1-based inclusive
    payload: dict
    filename: str


class RadarPipeline:
    """Compiled recording pipelines for a fixed RadarConfig."""

    def __init__(self, cfg: RadarConfig, filename: str = "radar_data",
                 impl: str = "auto"):
        # 'auto' = frame_chain.resolve_impl's choice for the backend.
        self.cfg = cfg
        self.filename = filename
        self._chain = make_frame_chain(cfg, impl=impl)

    # ---------------- jitted stages ----------------

    @functools.lru_cache(maxsize=16)
    def _stft_stage(self, nfft: int):
        """Jitted STFT→dB→log-rescale stage for one nfft bucket."""
        cfg = self.cfg
        a = cfg.algorithm
        op = StftOperator.create(
            window_length=a.stft_window_length,
            beta=a.stft_kaiser_beta,
            nfft=nfft,
            fs=1.0 / cfg.derived.prt,
            hop=a.stft_hop or 1,
            precision=a.matmul_precision,
        )

        @jax.jit
        def stage(signal_abs: jax.Array, valid_len: jax.Array):
            res = op(signal_abs, valid_len=valid_len)
            db = psd_db(res)
            log_bins, intensity = log_frequency_rescale(
                res.freqs, db, a.max_freq_bins)
            if a.intensity_dtype == "bfloat16":
                # Cast inside the program: halves the device write and the
                # transfer of the chain's largest tensor (see AlgorithmConfig).
                intensity = intensity.astype(jnp.bfloat16)
            elif a.intensity_dtype == "int8":
                from fmcw_radar_processing_tpu.dsp.stft import (
                    quantize_db_int8,
                )

                intensity = quantize_db_int8(intensity)
            return res.times, log_bins, intensity, res.freqs, db

        return stage, op

    # ---------------- host orchestration ----------------

    def run_chain(self, raw: np.ndarray, calib: np.ndarray) -> FrameChainOutputs:
        """Run the jitted per-frame chain.

        raw: [F, PN, NTS] complex (converted to the pair layout on host),
        pair [F, PN, NTS, 2] float32, or flat pair-rows [F, PN, 2·NTS];
        calib likewise [NTS]/[NTS, 2].

        Host NumPy input is reshaped to the FLAT row layout before crossing
        the jit boundary — a free view on the host, where an in-graph
        reshape of a [.., NTS, 2] parameter may be a relayout pass.
        """
        raw = _normalize_raw(raw, self.cfg.nts)
        if np.iscomplexobj(calib) or calib.ndim == 1:
            calib = to_pair(np.asarray(calib))
        return self._chain(jnp.asarray(raw), jnp.asarray(calib))

    def _spectrogram_of_signal(self, signal: jax.Array, count: int):
        """STFT of a packed slow-time signal (first ``count`` samples valid).

        Returns (times, log_bins, intensity) as NumPy arrays trimmed to the
        valid columns, or None if the signal is shorter than one window.
        """
        a = self.cfg.algorithm
        wl = a.stft_window_length
        if count < wl:
            return None
        nfft = a.stft_nfft or next_pow2(count)
        stage, op = self._stft_stage(nfft)
        sig_abs = pair_abs(signal)  # reference: STFT of |slow_time| (:270)
        times, log_bins, intensity, freqs, db = stage(sig_abs, jnp.asarray(count))
        n_valid = stft_frame_count(count, wl, op.hop)
        if a.intensity_dtype == "int8":
            from fmcw_radar_processing_tpu.dsp.stft import decode_db_int8

            intensity_np = decode_db_int8(intensity)
        else:
            intensity_np = np.asarray(intensity).astype(np.float32)
        return (
            np.asarray(times)[:n_valid],
            np.asarray(log_bins),
            intensity_np[:, :n_valid],
            np.asarray(freqs),
            np.asarray(db).astype(np.float32)[:, :n_valid],
        )

    def process_recording(
        self, raw: np.ndarray, calib: np.ndarray, timer=None
    ) -> RecordingOutputs:
        """Full-recording mode — radar_processing('no') (:195-436).

        timer: optional utils.observe.StageTimer — records per-stage,
        device-synced wall times (frame_chain / stft / payload_build).
        """
        from fmcw_radar_processing_tpu.utils.observe import NullTimer

        tm = timer if timer is not None else NullTimer()
        cfg = self.cfg
        with tm.stage("frame_chain", items=raw.shape[0]):
            out = self.run_chain(raw, calib)
            signal, count_dev = pack_slow_time(
                out.strongest_chirps, out.detected, cfg.pn
            )
            count = int(count_dev)  # the single host sync of the pipeline

        with tm.stage("stft", items=count):
            spec = tm.observe(self._spectrogram_of_signal(signal, count))
        if spec is None:
            times = np.zeros(0)
            log_bins = np.zeros(cfg.algorithm.max_freq_bins)
            intensity = np.zeros((cfg.algorithm.max_freq_bins, 0))
            lin_freqs = np.zeros(0)
            psd = np.zeros((0, 0))
        else:
            times, log_bins, intensity, lin_freqs, psd = spec

        with tm.stage("payload_build"):
            waterfall = np.asarray(out.waterfall).T  # (K, F)
            t_range = np.asarray(out.range)
            t_speed = np.asarray(out.speed)
            t_strength = np.asarray(out.strength)
            literal_mag = None
            if cfg.algorithm.compat_linear_index_snapshot:
                literal_mag = self._literal_snapshot_magnitude(raw, calib)

        payloads = {
            "spectrogram_data.json": spectrogram_payload(
                times, log_bins, intensity
            ),
            f"{self.filename}_range_fft_data.json": range_fft_payload(
                waterfall, cfg, self.filename
            ),
            f"{self.filename}_range_speed_data.json": range_speed_payload(
                t_range, t_speed, cfg, self.filename
            ),
            f"{self.filename}_fft_data.json": fft_snapshot_payload(
                waterfall, cfg, self.filename,
                literal_chirp_magnitude=literal_mag,
            ),
        }
        return RecordingOutputs(
            waterfall=waterfall,
            target_range=t_range,
            target_speed=t_speed,
            target_strength=t_strength,
            detected=np.asarray(out.detected),
            spectrogram_times=times,
            spectrogram_freqs=log_bins,
            spectrogram_intensity=intensity,
            spectrogram_linear_freqs=lin_freqs,
            spectrogram_psd_db=psd,
            payloads=payloads,
        )

    def _literal_snapshot_magnitude(
        self, raw: np.ndarray, calib: np.ndarray, chirp_1based: int = 100
    ) -> np.ndarray:
        """Quirk #2 literal value (compat_linear_index_snapshot):
        |range FFT| of chirp #``chirp_1based`` overall — what MATLAB
        column-linear indexing of the (K, PN, F) cube returns for
        ``range_tx1rx1_complete(:, 100)`` (radar_processing.m:410-411).
        Recomputed for the one owning frame via the packed operator (the
        cube itself is never materialized)."""
        from fmcw_radar_processing_tpu.dsp.fast_time import PackedFastTime
        from fmcw_radar_processing_tpu.utils.cplx import pair_abs, to_pair

        cfg = self.cfg
        raw = _normalize_raw(raw, cfg.nts)
        if np.iscomplexobj(calib) or calib.ndim == 1:
            calib = to_pair(np.asarray(calib))
        f = raw.shape[0]
        lin = min(chirp_1based - 1, f * cfg.pn - 1)  # 0-based, clamped
        fr, ch = lin // cfg.pn, lin % cfg.pn
        pft = PackedFastTime.create(cfg)
        rf = pft.rf(jnp.asarray(raw[fr : fr + 1]), jnp.asarray(calib))
        return np.asarray(pair_abs(rf[0, ch]))  # [K]

    def process_activity(
        self, raw: np.ndarray, calib: np.ndarray
    ) -> list[ActivityBatchOutput]:
        """Animal-activity batch mode — radar_processing('yes') (:440-607).

        Frames are processed in batches of ``batch_size`` (100); each batch
        with ≥ window_length slow-time samples yields one spectrogram JSON,
        capped at ``max_plots`` (4). The per-frame chain still runs ONCE
        over the whole recording — only packing + STFT are per batch.
        """
        cfg = self.cfg
        a = cfg.algorithm
        out = self.run_chain(raw, calib)
        f = raw.shape[0]
        num_batches = -(-f // a.batch_size)
        results: list[ActivityBatchOutput] = []
        plot_counter = 0
        for b in range(num_batches):
            if plot_counter >= a.max_plots:
                break  # :597-599
            start = b * a.batch_size
            end = min((b + 1) * a.batch_size, f)
            chirps = out.strongest_chirps[start:end]
            detected = out.detected[start:end]
            signal, count_dev = pack_slow_time(chirps, detected, cfg.pn)
            count = int(count_dev)
            spec = self._spectrogram_of_signal(signal, count)
            if spec is None:
                continue  # :534,601-606 insufficient data — no JSON
            plot_counter += 1
            times, log_bins, intensity = spec[:3]
            fname = f"{self.filename}_spectrogram_batch_{b + 1}.json"
            results.append(
                ActivityBatchOutput(
                    batch=b + 1,
                    start_frame=start + 1,
                    end_frame=end,
                    payload=spectrogram_payload(
                        times,
                        log_bins,
                        intensity,
                        batch=b + 1,
                        start_frame=start + 1,
                        end_frame=end,
                        filename_base=self.filename,
                    ),
                    filename=fname,
                )
            )
        return results
