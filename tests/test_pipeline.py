"""End-to-end pipeline vs the MATLAB-semantics oracle."""

import dataclasses
import json

import numpy as np
import pytest

from fmcw_radar_processing_tpu.pipeline.recording import RadarPipeline
from fmcw_radar_processing_tpu.utils.jsonio import dumps_matlab

from .conftest import make_recording
from .oracle import (
    log_rescale_oracle,
    process_recording_oracle,
    psd_db_oracle,
    spectrogram_oracle,
)


def _chain_layout(frames):
    return np.swapaxes(frames, -1, -2)


def _mixed_recording(cfg, rng, f=24):
    """Recording where some frames have a target and some don't."""
    frames, calib = make_recording(cfg, num_frames=f, rng=rng,
                                   target_bins=(55,), amplitude=4.0)
    # Kill the target in every third frame.
    noise = 0.003 * (rng.standard_normal(frames[::3].shape)
                     + 1j * rng.standard_normal(frames[::3].shape))
    frames[::3] = noise.astype(np.complex64)
    return frames, calib


def test_recording_outputs_match_oracle(cfg, rng):
    frames, calib = _mixed_recording(cfg, rng)
    pipe = RadarPipeline(cfg)
    got = pipe.process_recording(_chain_layout(frames), calib)
    want = process_recording_oracle(frames, calib, cfg)

    np.testing.assert_array_equal(got.detected, want.detected)
    assert got.detected.any() and not got.detected.all()
    np.testing.assert_allclose(got.waterfall, want.waterfall, rtol=3e-4, atol=0.05)
    np.testing.assert_allclose(got.target_range, want.range, rtol=1e-5)
    np.testing.assert_allclose(got.target_speed, want.speed, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.target_strength, want.strength,
                               rtol=3e-4, atol=0.05)


def test_slow_time_packing_matches_oracle(cfg, rng):
    from fmcw_radar_processing_tpu.pipeline.frame_chain import pack_slow_time

    frames, calib = _mixed_recording(cfg, rng)
    pipe = RadarPipeline(cfg)
    out = pipe.run_chain(_chain_layout(frames), calib)
    signal, count = pack_slow_time(out.strongest_chirps, out.detected, cfg.pn)
    want = process_recording_oracle(frames, calib, cfg)
    count = int(count)
    assert count == len(want.slow_time_signal)
    from fmcw_radar_processing_tpu.utils.cplx import from_pair
    np.testing.assert_allclose(
        from_pair(signal)[:count], want.slow_time_signal, rtol=3e-4, atol=0.05
    )


def test_slow_time_packing_edge_cases(cfg):
    """Stable-partition pack: zero/all/interleaved detection patterns.

    Pins the semantics the argsort-compaction rewrite must preserve
    (radar_processing.m:255-260): detected frames' chirp rows packed in
    frame order, zeros past the valid count."""
    import numpy as np

    from fmcw_radar_processing_tpu.pipeline.frame_chain import pack_slow_time

    f, pn = 9, cfg.pn
    chirps = np.arange(f * pn * 2, dtype=np.float32).reshape(f, pn, 2)

    sig, count = pack_slow_time(chirps, np.zeros(f, bool), pn)
    assert int(count) == 0
    np.testing.assert_array_equal(np.asarray(sig), 0.0)

    sig, count = pack_slow_time(chirps, np.ones(f, bool), pn)
    assert int(count) == f * pn
    np.testing.assert_array_equal(np.asarray(sig), chirps.reshape(-1, 2))

    det = np.array([False, True, False, True, True, False, False, True,
                    False])
    sig, count = pack_slow_time(chirps, det, pn)
    assert int(count) == det.sum() * pn
    want = chirps[det].reshape(-1, 2)
    got = np.asarray(sig)
    np.testing.assert_array_equal(got[: int(count)], want)
    np.testing.assert_array_equal(got[int(count):], 0.0)


def test_spectrogram_intensity_matches_oracle(cfg, rng):
    frames, calib = _mixed_recording(cfg, rng)
    pipe = RadarPipeline(cfg)
    got = pipe.process_recording(_chain_layout(frames), calib)
    want = process_recording_oracle(frames, calib, cfg)

    iq = np.abs(want.slow_time_signal)
    fs = 1.0 / cfg.derived.prt
    freqs, times, p = spectrogram_oracle(iq, fs)
    db = psd_db_oracle(p)
    log_bins, intensity = log_rescale_oracle(freqs, db)

    np.testing.assert_allclose(got.spectrogram_times, times, rtol=1e-6)
    np.testing.assert_allclose(got.spectrogram_freqs, log_bins, rtol=1e-5)
    assert got.spectrogram_intensity.shape == intensity.shape
    # dB compare where the oracle is above the noise floor.
    mask = intensity > -120
    np.testing.assert_allclose(
        got.spectrogram_intensity[mask], intensity[mask], atol=0.05
    )


def test_payload_schemas(cfg, rng):
    frames, calib = _mixed_recording(cfg, rng)
    pipe = RadarPipeline(cfg, filename="radar_data")
    got = pipe.process_recording(_chain_layout(frames), calib)
    names = set(got.payloads)
    assert names == {
        "spectrogram_data.json",
        "radar_data_range_fft_data.json",
        "radar_data_range_speed_data.json",
        "radar_data_fft_data.json",
    }
    spec = json.loads(dumps_matlab(got.payloads["spectrogram_data.json"]))
    assert set(spec) == {"time", "frequency", "intensity", "title", "xLabel", "yLabel"}
    assert len(spec["frequency"]) == 1024
    assert len(spec["intensity"]) == 1024  # rows = frequency bins

    rf = json.loads(dumps_matlab(got.payloads["radar_data_range_fft_data.json"]))
    assert set(rf) == {"time_axis", "array_bin_range", "range_tx1rx1_max_abs",
                       "filename"}
    assert len(rf["range_tx1rx1_max_abs"]) == cfg.range_fft_size
    assert len(rf["time_axis"]) == frames.shape[0]
    assert rf["time_axis"][1] == 0.15

    rs = json.loads(dumps_matlab(got.payloads["radar_data_range_speed_data.json"]))
    # max_num_targets = 1 ⇒ MATLAB encodes the 1×F matrix as a flat array,
    # with NaN → null.
    assert len(rs["range"]) == frames.shape[0]
    undetected = np.where(~got.detected)[0]
    assert rs["range"][int(undetected[0])] is None

    fd = json.loads(dumps_matlab(got.payloads["radar_data_fft_data.json"]))
    assert fd["frame_index"] == min(100, frames.shape[0])
    assert len(fd["magnitude"]) == cfg.range_fft_size


def test_activity_mode_batches(cfg, rng):
    frames, calib = _mixed_recording(cfg, rng, f=30)
    # Small batches so several spectrograms emerge from 30 frames.
    import dataclasses

    alg = dataclasses.replace(cfg.algorithm, batch_size=8, max_plots=2)
    from fmcw_radar_processing_tpu.config import RadarConfig

    cfg2 = RadarConfig.create(cfg.device, alg)
    pipe = RadarPipeline(cfg2)
    batches = pipe.process_activity(_chain_layout(frames), calib)
    assert 1 <= len(batches) <= 2  # capped at max_plots
    b = batches[0]
    assert b.batch == 1 and b.start_frame == 1 and b.end_frame == 8
    assert b.payload["title"] == "Spectrogram - Batch 1"
    assert b.payload["start_frame"] == 1
    assert b.filename == "radar_data_spectrogram_batch_1.json"


def test_activity_batch_matches_oracle_spectrogram(cfg, rng):
    import dataclasses

    from fmcw_radar_processing_tpu.config import RadarConfig

    frames, calib = _mixed_recording(cfg, rng, f=16)
    alg = dataclasses.replace(cfg.algorithm, batch_size=8)
    cfg2 = RadarConfig.create(cfg.device, alg)
    pipe = RadarPipeline(cfg2)
    batches = pipe.process_activity(_chain_layout(frames), calib)

    # Oracle for batch 1 == oracle of the first 8 frames.
    want_b = process_recording_oracle(frames[:8], calib, cfg2)
    iq = np.abs(want_b.slow_time_signal)
    if len(iq) >= 20:
        fs = 1.0 / cfg2.derived.prt
        freqs, times, p = spectrogram_oracle(iq, fs)
        db = psd_db_oracle(p)
        log_bins, intensity = log_rescale_oracle(freqs, db)
        got = batches[0]
        np.testing.assert_allclose(
            np.asarray(got.payload["time"]), times, rtol=1e-6
        )
        mask = intensity > -120
        np.testing.assert_allclose(
            np.asarray(got.payload["intensity"])[mask], intensity[mask], atol=0.05
        )


def test_run_chain_accepts_all_raw_layouts(cfg, rng):
    """ADVICE r2 (medium): the documented flat pair-row layout
    [F, PN, 2·NTS] crashed run_chain — a real ndim-3 array was pair-ified
    by ndim alone. All four accepted layouts must give identical outputs,
    disambiguated by last-dim size."""
    from fmcw_radar_processing_tpu.utils.cplx import to_pair

    frames, calib = _mixed_recording(cfg, rng, f=8)
    cplx = _chain_layout(frames)  # [F, PN, NTS] complex
    pipe = RadarPipeline(cfg)

    ref = pipe.run_chain(cplx, calib)
    pair = to_pair(cplx)  # [F, PN, NTS, 2]
    flat = pair.reshape(*pair.shape[:2], -1)  # [F, PN, 2·NTS] real float!
    for alt in (pair, flat):
        got = pipe.run_chain(alt, calib)
        np.testing.assert_array_equal(
            np.asarray(got.waterfall), np.asarray(ref.waterfall)
        )
        np.testing.assert_array_equal(
            np.asarray(got.detected), np.asarray(ref.detected)
        )

    # Real samples [F, PN, NTS] (imag = 0) go through to_pair, not crash.
    real = np.ascontiguousarray(cplx.real)
    out_real = pipe.run_chain(real, calib)
    assert np.asarray(out_real.waterfall).shape == ref.waterfall.shape

    # An ndim-3 last dim that is neither NTS nor 2·NTS is rejected loudly.
    import pytest

    with pytest.raises(ValueError, match="neither"):
        pipe.run_chain(np.zeros((4, cfg.pn, cfg.nts + 3), np.float32), calib)


def test_bf16_intensity_option(cfg, rng):
    """intensity_dtype='bfloat16' halves the largest device tensor; the
    payload still comes back float32 and within bf16 quantization (~0.4%
    relative => sub-dB absolute on display values) of the f32 run."""
    import dataclasses

    from fmcw_radar_processing_tpu.config import RadarConfig

    frames, calib = _mixed_recording(cfg, rng)
    pipe32 = RadarPipeline(cfg)
    a16 = dataclasses.replace(cfg.algorithm, intensity_dtype="bfloat16")
    pipe16 = RadarPipeline(RadarConfig.create(cfg.device, a16))
    got32 = pipe32.process_recording(_chain_layout(frames), calib)
    got16 = pipe16.process_recording(_chain_layout(frames), calib)

    assert got16.spectrogram_intensity.dtype == np.float32
    m = got32.spectrogram_intensity > -120
    np.testing.assert_allclose(
        got16.spectrogram_intensity[m], got32.spectrogram_intensity[m],
        atol=0.5,  # bf16 8-bit mantissa on dB magnitudes up to ~120
    )


def test_production_profile_display_band(cfg, rng):
    """The production profile (bf16 intensity, "high" matmuls) holds the
    display band within the 0.15 dB criterion against the f32 fidelity
    pipeline on the same nfft bucket."""
    import dataclasses

    from fmcw_radar_processing_tpu.config import AlgorithmConfig, RadarConfig

    frames, calib = _mixed_recording(cfg, rng)
    a_ref = dataclasses.replace(cfg.algorithm, stft_nfft=256)
    a_prod = AlgorithmConfig.production()
    got_r = RadarPipeline(RadarConfig.create(cfg.device, a_ref)).process_recording(
        _chain_layout(frames), calib)
    got_p = RadarPipeline(RadarConfig.create(cfg.device, a_prod)).process_recording(
        _chain_layout(frames), calib)
    m = got_r.spectrogram_intensity > -40
    err = np.abs(got_p.spectrogram_intensity[m]
                 - got_r.spectrogram_intensity[m]).max()
    assert err <= 0.16, err  # 0.15 criterion + comparison slack
    # The exported dB map (the PNG source) stays f32.
    assert got_p.spectrogram_psd_db.dtype == np.float32
    md = got_r.spectrogram_psd_db > -40
    errd = np.abs(got_p.spectrogram_psd_db[md]
                  - got_r.spectrogram_psd_db[md]).max()
    assert errd <= 0.15, errd


def test_int8_intensity_option(cfg, rng):
    """intensity_dtype='int8': the payload comes back float32 with
    each displayed bin within half a quantization step (≈0.083 dB ≤ the
    0.15 dB display-band criterion) of the f32 run; sub-range bins clamp
    to INT8_DB_RANGE's floor."""
    import dataclasses

    from fmcw_radar_processing_tpu.config import RadarConfig
    from fmcw_radar_processing_tpu.dsp.stft import INT8_DB_RANGE, int8_db_step

    frames, calib = _mixed_recording(cfg, rng)
    a32 = cfg.algorithm
    a8 = dataclasses.replace(cfg.algorithm, intensity_dtype="int8")
    got32 = RadarPipeline(RadarConfig.create(cfg.device, a32)).process_recording(
        _chain_layout(frames), calib)
    got8 = RadarPipeline(RadarConfig.create(cfg.device, a8)).process_recording(
        _chain_layout(frames), calib)

    assert got8.spectrogram_intensity.dtype == np.float32
    lo, _ = INT8_DB_RANGE
    inside = got32.spectrogram_intensity > lo + 0.1
    assert inside.sum() > 50
    np.testing.assert_allclose(
        got8.spectrogram_intensity[inside],
        got32.spectrogram_intensity[inside],
        atol=int8_db_step() / 2 + 2e-3,
    )
    below = got32.spectrogram_intensity < lo - 1.0
    assert np.all(got8.spectrogram_intensity[below] == np.float32(lo))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_export_intensity_dtypes_match_oracle(cfg, rng, dtype):
    """The XLA spectrogram export in each intensity storage dtype holds the
    display band (oracle bins ≥ −40 dB, the reference PNG's clim) within
    its quantization bound of the f64 oracle."""
    import dataclasses

    from fmcw_radar_processing_tpu.config import RadarConfig
    from fmcw_radar_processing_tpu.dsp.stft import int8_db_step

    frames, calib = _mixed_recording(cfg, rng)
    alg = dataclasses.replace(cfg.algorithm, stft_nfft=256,
                              intensity_dtype=dtype)
    ccfg = RadarConfig.create(cfg.device, alg)
    got = RadarPipeline(ccfg).process_recording(_chain_layout(frames), calib)
    want = process_recording_oracle(frames, calib, ccfg)
    freqs, _, p = spectrogram_oracle(np.abs(want.slow_time_signal),
                                     1.0 / cfg.derived.prt, nfft=256)
    _, want_i = log_rescale_oracle(freqs, psd_db_oracle(p))
    assert got.spectrogram_intensity.dtype == np.float32
    assert got.spectrogram_intensity.shape == want_i.shape
    band = want_i >= -40.0
    err = np.abs(got.spectrogram_intensity - want_i)[band].max()
    bound = {"float32": 1e-3, "bfloat16": 0.125 + 1e-3,
             "int8": int8_db_step() / 2 + 1e-3}[dtype]
    assert err <= bound, (dtype, err)


def test_algorithm_config_has_no_device_knobs():
    """The removed export knobs stay removed; production() sets only the
    STFT bucket, the intensity dtype and the matmul precision."""
    from fmcw_radar_processing_tpu.config import AlgorithmConfig

    fields = {f.name for f in dataclasses.fields(AlgorithmConfig)}
    assert not fields & {"stft_impl", "stft_psd_precision", "stft_psd_store",
                         "stft_db_store", "rescale_method",
                         "rescale_precision"}
    base, prod = AlgorithmConfig(), AlgorithmConfig.production()
    changed = {f for f in fields if getattr(base, f) != getattr(prod, f)}
    assert changed == {"stft_nfft", "intensity_dtype", "matmul_precision"}
    assert AlgorithmConfig.production(stft_nfft=512).stft_nfft == 512
