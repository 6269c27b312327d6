"""Fused (packed-matmul, rf-never-materialized) chain vs XLA reference impl."""

import numpy as np
import pytest
import jax.numpy as jnp

from fmcw_radar_processing_tpu.dsp.fast_time import (
    FastTimeOperator,
    PackedFastTime,
    range_profile,
)
from fmcw_radar_processing_tpu.pipeline.frame_chain import make_frame_chain
from fmcw_radar_processing_tpu.pipeline.recording import RadarPipeline
from fmcw_radar_processing_tpu.utils.cplx import to_pair

from .conftest import make_recording
from .test_pipeline import _chain_layout, _mixed_recording


def _inputs(cfg, rng, f=12, **kw):
    frames, calib = make_recording(cfg, num_frames=f, rng=rng, **kw)
    return (jnp.asarray(to_pair(np.swapaxes(frames, -1, -2))),
            jnp.asarray(to_pair(calib)))


def test_packed_rf_matches_einsum(cfg, rng):
    raw, calib = _inputs(cfg, rng)
    ft = FastTimeOperator.create(cfg)
    pft = PackedFastTime.create(cfg)
    a = np.asarray(ft(raw, calib))
    b = np.asarray(pft.rf(raw, calib))
    scale = np.abs(a).max()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * scale)


def test_packed_profile_matches(cfg, rng):
    raw, calib = _inputs(cfg, rng)
    ft = FastTimeOperator.create(cfg)
    pft = PackedFastTime.create(cfg)
    a = np.asarray(range_profile(ft(raw, calib)))
    b = np.asarray(pft.profile(raw, calib))
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4 * a.max())


def test_rf_at_bins_matches_gather(cfg, rng):
    raw, calib = _inputs(cfg, rng)
    pft = PackedFastTime.create(cfg)
    rf = np.asarray(pft.rf(raw, calib))  # [F, PN, K, 2]
    f = raw.shape[0]
    idx = jnp.asarray(
        np.random.default_rng(0).integers(0, cfg.range_fft_size, (f, 3))
    )
    rows = np.asarray(pft.rf_at_bins(raw, calib, idx))  # [F, PN, 3, 2]
    expect = np.take_along_axis(
        rf, np.asarray(idx)[:, None, :, None], axis=-2
    )
    scale = np.abs(rf).max()
    np.testing.assert_allclose(rows, expect, rtol=1e-5, atol=1e-5 * scale)


def test_fused_chain_matches_xla(cfg, rng):
    raw, calib = _inputs(cfg, rng, f=16)
    fused = make_frame_chain(cfg, impl="fused")(raw, calib)
    xla = make_frame_chain(cfg, impl="xla")(raw, calib)
    np.testing.assert_array_equal(np.asarray(fused.detected),
                                  np.asarray(xla.detected))
    np.testing.assert_array_equal(np.asarray(fused.detection.idx),
                                  np.asarray(xla.detection.idx))
    # packed 1-matmul vs 4-einsum differ in f32 accumulation order
    np.testing.assert_allclose(np.asarray(fused.waterfall),
                               np.asarray(xla.waterfall), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(fused.range), np.asarray(xla.range),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(fused.speed), np.asarray(xla.speed),
                               rtol=1e-5, atol=1e-6)
    scale = float(np.nanmax(np.abs(np.asarray(xla.strongest_chirps))))
    np.testing.assert_allclose(
        np.asarray(fused.strongest_chirps), np.asarray(xla.strongest_chirps),
        rtol=1e-4, atol=1e-5 * scale,
    )


def test_fused_chain_with_range_fft_output(cfg, rng):
    """return_range_fft=True falls back to materializing (still packed)."""
    raw, calib = _inputs(cfg, rng)
    fused = make_frame_chain(cfg, impl="fused", return_range_fft=True)(raw, calib)
    xla = make_frame_chain(cfg, impl="xla", return_range_fft=True)(raw, calib)
    assert fused.range_fft is not None
    scale = float(np.abs(np.asarray(xla.range_fft)).max())
    np.testing.assert_allclose(
        np.asarray(fused.range_fft), np.asarray(xla.range_fft),
        rtol=1e-5, atol=1e-5 * scale,
    )


def test_chain_flat_row_layout_matches_pair(cfg, rng):
    """Flat [F, PN, 2·NTS] pair-rows (the layout-lean input format,
    see PackedFastTime._flat_rows) must be bit-identical to the pair
    layout across impls."""
    import numpy as np

    from fmcw_radar_processing_tpu.pipeline.frame_chain import make_frame_chain

    from fmcw_radar_processing_tpu.utils.cplx import to_pair

    frames, calib = _mixed_recording(cfg, rng, f=8)
    raw = to_pair(np.asarray(_chain_layout(frames)))  # [F, PN, NTS, 2]
    calib = to_pair(np.asarray(calib))
    flat = np.asarray(raw).reshape(raw.shape[0], cfg.pn, -1)
    for impl in ("fused", "xla"):
        chain = make_frame_chain(cfg, impl=impl)
        a = chain(raw, calib)
        b = chain(flat, calib)
        np.testing.assert_array_equal(np.asarray(a.waterfall),
                                      np.asarray(b.waterfall))
        np.testing.assert_array_equal(np.asarray(a.strongest_chirps),
                                      np.asarray(b.strongest_chirps))
        np.testing.assert_array_equal(np.asarray(a.speed), np.asarray(b.speed))


def test_fused_chain_no_detection_frames(cfg, rng):
    """Frames without targets: rf_at_bins runs on garbage idx, outputs NaN-
    gated by `detected` downstream — must not crash or emit false tracks."""
    raw, calib = _inputs(cfg, rng, target_bins=(), amplitude=0.0)
    out = make_frame_chain(cfg, impl="fused")(raw, calib)
    ref = make_frame_chain(cfg, impl="xla")(raw, calib)
    np.testing.assert_array_equal(np.asarray(out.detected),
                                  np.asarray(ref.detected))
    mask = ~np.asarray(out.detection.valid).T
    if mask.any():
        assert np.isnan(np.asarray(out.range)[mask]).all()


def test_resolve_impl_auto():
    """'auto' is the fused XLA path on every platform; explicit impls pass
    through."""
    from fmcw_radar_processing_tpu.pipeline.frame_chain import resolve_impl

    assert resolve_impl("fused") == "fused"
    assert resolve_impl("xla") == "xla"
    assert resolve_impl("auto") == "fused"


def test_make_frame_chain_rejects_unknown_impl(cfg):
    from fmcw_radar_processing_tpu.pipeline.frame_chain import make_frame_chain

    with pytest.raises(ValueError, match="unknown impl"):
        make_frame_chain(cfg, impl="triton")


def test_bf16_pipeline_detections_match_f32(cfg, rng):
    """fused_bf16: detections and measurements identical on well-separated
    targets; waterfall within bf16 quantization error."""
    frames, calib = _mixed_recording(cfg, rng, f=12)
    f32 = RadarPipeline(cfg, impl="fused").process_recording(
        _chain_layout(frames), calib
    )
    b16 = RadarPipeline(cfg, impl="fused_bf16").process_recording(
        _chain_layout(frames), calib
    )
    np.testing.assert_array_equal(b16.detected, f32.detected)
    np.testing.assert_allclose(b16.target_range, f32.target_range, rtol=1e-6)
    err = np.linalg.norm(b16.waterfall - f32.waterfall) / max(
        np.linalg.norm(f32.waterfall), 1e-30
    )
    assert -20 * np.log10(max(err, 1e-30)) > 30.0
