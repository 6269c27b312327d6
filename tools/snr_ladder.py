"""Per-stage SNR ladder vs the float64 MATLAB-semantics oracle.

Localizes where the chain's precision goes, stage by stage, and stratifies
the dB-domain error by signal level so the bound can be stated precisely.

Stages measured (each vs the f64 oracle of tests/oracle.py):

  1. slow_time   — packed complex slow-time signal (chain output)
  2. magnitude   — |slow_time| fed to the STFT
  3. psd_linear  — framed-matmul one-sided PSD (linear power)
  4. psd_db      — 20·log10(P/max) dB map, full + per-band
  5. intensity   — log-frequency-rescaled 1024-bin dB map, full + per-band

The expected shape of the result (pinned in tests/test_snr_ladder.py): the
LINEAR PSD holds high SNR; the dB map's full-map SNR is lower because the
log expands tiny relative errors at spectral NULLS (f32 cancellation in the
20-tap windowed sum produces large *relative* error exactly where the true
power is ~0). Restricted to any displayable band (the reference renders
clim [-40, 0] dB, radar_processing.m:344), the SNR recovers to the
waterfall's level.

Run from the repo root: python tools/snr_ladder.py [out.json]
(default chiprun_out/snr_ladder.json); prints the table. One ladder per
matmul_precision name (utils/cplx.mxu_precision says what each runs as).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np


def snr_db(got, want, mask=None) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if mask is not None:
        got, want = got[mask], want[mask]
    if got.size == 0:
        return float("nan")
    err = np.linalg.norm(got - want)
    ref = np.linalg.norm(want)
    if err == 0.0:
        return float("inf")
    return float(-20.0 * np.log10(err / max(ref, 1e-300)))


def build_ladder(frames: int = 256, nfft: int = 256, seed: int = 0,
                 precision: str = "highest") -> dict:
    from fmcw_radar_processing_tpu.config import (
        AlgorithmConfig,
        RadarConfig,
        default_device_config,
    )
    from fmcw_radar_processing_tpu.dsp.stft import (
        DB_FLOOR,
        StftOperator,
        log_frequency_rescale,
        psd_db,
    )
    from fmcw_radar_processing_tpu.io.synth import (
        SyntheticTarget,
        synthesize_recording,
    )
    from fmcw_radar_processing_tpu.pipeline.frame_chain import (
        make_frame_chain,
        pack_slow_time,
    )
    from fmcw_radar_processing_tpu.utils.cplx import from_pair, pair_abs
    from tests.oracle import (
        log_rescale_oracle,
        process_recording_oracle,
        psd_db_oracle,
        spectrogram_oracle,
    )

    import jax

    cfg = RadarConfig.create(
        default_device_config(),
        AlgorithmConfig(stft_nfft=nfft, matmul_precision=precision),
    )
    rec = synthesize_recording(
        cfg, frames,
        (SyntheticTarget(range_m=7.5, doppler_bin_offset=3,
                         md_phase_rad=1.0, md_rate_hz=40.0),
         SyntheticTarget(range_m=16.9, doppler_bin_offset=-2, amplitude=2.5)),
        seed=seed,
    )
    raw = rec.rx1_pair()
    calib = rec.calib_pair(0, cfg.nts)

    # ---- f32 pipeline (every device stage jitted) ----
    chain = make_frame_chain(cfg)
    op = StftOperator.create(
        window_length=cfg.algorithm.stft_window_length,
        beta=cfg.algorithm.stft_kaiser_beta, nfft=nfft,
        fs=1.0 / cfg.derived.prt, hop=1, precision=precision,
    )

    @jax.jit
    def stft_stage(sig, count):
        res = op(pair_abs(sig), valid_len=count)
        db = psd_db(res)
        _, intensity = log_frequency_rescale(
            res.freqs, db, cfg.algorithm.max_freq_bins)
        return res.power, db, intensity, res.freqs

    out = chain(raw.reshape(frames, cfg.pn, -1), calib)
    sig, count_dev = pack_slow_time(out.strongest_chirps, out.detected, cfg.pn)
    count = int(count_dev)
    mag = np.asarray(pair_abs(sig))[:count]
    slow_c = np.asarray(from_pair(sig))[:count]
    power_d, db_d, int_d, _freqs = stft_stage(sig, count_dev)
    ncols = count - cfg.algorithm.stft_window_length + 1
    p32 = np.asarray(power_d)[:, :ncols]
    db32 = np.asarray(db_d)[:, :ncols]
    int32 = np.asarray(int_d)[:, :ncols]

    # ---- f64 oracle ----
    raw_matlab = np.swapaxes(rec.rx1()[:frames], -1, -2)
    want = process_recording_oracle(raw_matlab, rec.calib_vector(0, cfg.nts),
                                    cfg)
    iq64 = np.abs(want.slow_time_signal)
    freqs, _, p64 = spectrogram_oracle(iq64, 1.0 / cfg.derived.prt, nfft=nfft)
    db64 = psd_db_oracle(p64)
    _, int64 = log_rescale_oracle(freqs, db64)
    db64f = np.maximum(db64, DB_FLOOR)
    int64f = np.maximum(int64, DB_FLOOR)

    assert count == len(iq64), (count, len(iq64))
    assert p32.shape == p64.shape

    # ---- the ladder ----
    ladder: dict[str, object] = {
        "frames": frames, "nfft": nfft,
        "device_kind": jax.devices()[0].device_kind,
        "matmul_precision": precision,
        "stft_columns": int(p32.shape[1]),
        "1_slow_time_snr_db": round(snr_db(
            np.stack([slow_c.real, slow_c.imag]),
            np.stack([want.slow_time_signal.real,
                      want.slow_time_signal.imag])), 1),
        "2_magnitude_snr_db": round(snr_db(mag, iq64), 1),
        "3_psd_linear_snr_db": round(snr_db(p32, p64), 1),
        "4_psd_db_full_snr_db": round(snr_db(db32, db64f), 1),
        "5_intensity_full_snr_db": round(snr_db(int32, int64f), 1),
    }

    # dB-domain error stratified by the ORACLE's level: where does the dB
    # error live? (clim band = what the reference's PNG actually displays)
    for name, got, ref in (("psd_db", db32, db64f),
                           ("intensity", int32, int64f)):
        bands = {}
        for lo, label in ((-40.0, "display_band_ge_-40dB"),
                          (-80.0, "ge_-80dB"),
                          (-120.0, "ge_-120dB")):
            m = ref >= lo
            bands[label] = {
                "snr_db": round(snr_db(got, ref, m), 1),
                "max_abs_err_db": round(float(np.max(np.abs(got - ref)[m]))
                                        if m.any() else float("nan"), 3),
                "fraction_of_bins": round(float(np.mean(m)), 4),
            }
        m = ref < -120.0
        bands["floor_lt_-120dB"] = {
            "snr_db": round(snr_db(got, ref, m), 1),
            "max_abs_err_db": round(float(np.max(np.abs(got - ref)[m]))
                                    if m.any() else float("nan"), 3),
            "fraction_of_bins": round(float(np.mean(m)), 4),
        }
        ladder[f"{name}_bands"] = bands

    # Relative linear-power error stratified the same way: shows the f32
    # cancellation at nulls directly (relative error explodes exactly where
    # absolute power vanishes).
    rel = np.abs(p32 - p64) / np.maximum(p64, 1e-300)
    strata = {}
    for lo, label in ((-40.0, "ge_-40dB"), (-80.0, "ge_-80dB"),
                      (-120.0, "ge_-120dB")):
        m = db64f >= lo
        strata[label] = round(float(np.median(rel[m])) if m.any() else
                              float("nan"), 9)
    m = db64f < -120.0
    strata["floor_lt_-120dB"] = round(float(np.median(rel[m])) if m.any()
                                      else float("nan"), 6)
    ladder["psd_linear_median_rel_err_by_band"] = strata
    return ladder


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "chiprun_out/snr_ladder.json"
    import jax

    out = {"device_kind": jax.devices()[0].device_kind}
    out.update({p: build_ladder(precision=p)
                for p in ("default", "high", "highest")})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
