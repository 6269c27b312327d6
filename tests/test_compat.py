"""Literal-compat flags for SURVEY Appendix A quirks #1/#2 (VERDICT r1
item 7): with the flags on, payloads reproduce what a real MATLAB run of
the reference exports — validated against independent oracle re-statements
of the MATLAB semantics (array auto-growth, column-linear indexing)."""

import dataclasses

import numpy as np

from fmcw_radar_processing_tpu.config import (
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu.pipeline.payloads import (
    transposed_measurements_literal,
)
from fmcw_radar_processing_tpu.pipeline.recording import RadarPipeline

from .oracle import (
    literal_measurements_oracle,
    literal_snapshot_oracle,
    matlab_grow_write,
    process_recording_oracle,
)
from .test_pipeline import _mixed_recording, _chain_layout


def _compat_cfg(**alg_kwargs) -> RadarConfig:
    return RadarConfig.create(default_device_config(),
                              AlgorithmConfig(**alg_kwargs))


def test_matlab_grow_write_semantics():
    a = np.zeros((1, 4))
    a = matlab_grow_write(a, 1, 1, 5.0)
    assert a.shape == (1, 4) and a[0, 0] == 5.0
    a = matlab_grow_write(a, 3, 1, 7.0)  # grows rows, zero fill
    assert a.shape == (3, 4)
    assert a[2, 0] == 7.0 and a[1, 0] == 0.0 and a[0, 1] == 0.0


def test_transposed_measurements_match_oracle(cfg, rng):
    frames, calib = _mixed_recording(cfg, rng, f=24)
    ccfg = _compat_cfg(compat_transposed_measurements=True)
    out = RadarPipeline(ccfg).process_recording(_chain_layout(frames), calib)
    payload = out.payloads["radar_data_range_speed_data.json"]

    want = process_recording_oracle(frames, calib, ccfg)
    want_rng, want_spd = literal_measurements_oracle(want, ccfg)
    assert payload["range"].shape == want_rng.shape  # grown (F', F) layout
    np.testing.assert_allclose(payload["range"], want_rng, rtol=1e-5)
    np.testing.assert_allclose(payload["speed"], want_spd, rtol=1e-5, atol=1e-6)
    # Literal layout has zeros (not NaN) at unwritten cells.
    assert not np.isnan(payload["range"]).any()
    # Default (intent) mode keeps the canonical (T, F) NaN layout.
    out_intent = RadarPipeline(cfg).process_recording(_chain_layout(frames), calib)
    p_intent = out_intent.payloads["radar_data_range_speed_data.json"]
    assert p_intent["range"].shape == (cfg.algorithm.max_num_targets, 24)
    assert np.isnan(p_intent["range"]).any()


def test_transposed_literal_builder_against_growth_replay(rng):
    """Pipeline's vectorized literal builder == loop-based MATLAB replay,
    including multi-target growth."""
    t, f = 3, 11
    canonical = np.full((t, f), np.nan)
    vals = {(0, 2): 1.5, (1, 2): 2.5, (0, 7): 3.5, (2, 9): 4.5}
    for (j, fr), v in vals.items():
        canonical[j, fr] = v
    got = transposed_measurements_literal(canonical)
    want = np.zeros((t, f))
    for fr in range(f):
        for j in range(t):
            if not np.isnan(canonical[j, fr]):
                want = matlab_grow_write(want, fr + 1, j + 1, canonical[j, fr])
    np.testing.assert_array_equal(got, want)
    assert got.shape == (10, f)  # grew to the last written frame (1-based)


def test_linear_index_snapshot_matches_oracle(cfg, rng):
    frames, calib = _mixed_recording(cfg, rng, f=24)  # 24·16 = 384 chirps
    ccfg = _compat_cfg(compat_linear_index_snapshot=True)
    out = RadarPipeline(ccfg).process_recording(_chain_layout(frames), calib)
    payload = out.payloads["radar_data_fft_data.json"]

    want = process_recording_oracle(frames, calib, ccfg)
    want_mag = literal_snapshot_oracle(want, chirp_1based=100)
    # chirp #100 = frame 7 chirp 4 (1-based) — NOT the frame-100 profile.
    np.testing.assert_allclose(payload["magnitude"], want_mag,
                               rtol=3e-4, atol=0.05)
    assert payload["frame_index"] == 100  # the reference's literal label
    # And it differs from the intent-mode (integrated frame) snapshot.
    out_i = RadarPipeline(cfg).process_recording(_chain_layout(frames), calib)
    intent_mag = out_i.payloads["radar_data_fft_data.json"]["magnitude"]
    assert not np.allclose(payload["magnitude"], intent_mag)
