"""Fused fast-time operator vs the per-step MATLAB-semantics oracle."""

import jax.numpy as jnp
import numpy as np

from fmcw_radar_processing_tpu.dsp.fast_time import FastTimeOperator, range_profile
from fmcw_radar_processing_tpu.utils.cplx import from_pair, to_pair

from .conftest import make_recording
from .oracle import fast_time_oracle, integrate_profile_oracle


def _chain_layout(frames_matlab: np.ndarray) -> np.ndarray:
    """(F, NTS, PN) MATLAB layout → (F, PN, NTS, 2) pair layout."""
    return to_pair(np.swapaxes(frames_matlab, -1, -2))


def test_fused_operator_matches_oracle(cfg, rng):
    frames, calib = make_recording(cfg, num_frames=5, rng=rng)
    op = FastTimeOperator.create(cfg)
    got = from_pair(op(jnp.asarray(_chain_layout(frames)),
                       jnp.asarray(to_pair(calib))))
    for fr in range(frames.shape[0]):
        want = fast_time_oracle(frames[fr], calib, cfg)  # (K, PN)
        np.testing.assert_allclose(got[fr].T, want, rtol=2e-4, atol=2e-2)


def test_real_input_supported(cfg, rng):
    """Devices with real-only ADC data (I channel) must work too."""
    frames, calib = make_recording(cfg, num_frames=2, rng=rng)
    frames = frames.real.astype(np.float32)
    op = FastTimeOperator.create(cfg)
    got = from_pair(op(jnp.asarray(_chain_layout(frames)),
                       jnp.asarray(to_pair(calib))))
    want = fast_time_oracle(frames[0].astype(np.complex128), calib, cfg)
    np.testing.assert_allclose(got[0].T, want, rtol=2e-4, atol=2e-2)


def test_profile_is_max_magnitude_over_chirps(cfg, rng):
    frames, calib = make_recording(cfg, num_frames=3, rng=rng)
    op = FastTimeOperator.create(cfg)
    rf = op(jnp.asarray(_chain_layout(frames)), jnp.asarray(to_pair(calib)))
    got = np.asarray(range_profile(rf))
    for fr in range(frames.shape[0]):
        want = integrate_profile_oracle(fast_time_oracle(frames[fr], calib, cfg))
        np.testing.assert_allclose(got[fr], want, rtol=2e-4, atol=2e-2)


def test_target_lands_in_expected_bin(cfg, rng):
    frames, calib = make_recording(cfg, num_frames=1, rng=rng,
                                   target_bins=(40,), amplitude=5.0)
    op = FastTimeOperator.create(cfg)
    rf = op(jnp.asarray(_chain_layout(frames)), jnp.asarray(to_pair(calib)))
    profile = np.asarray(range_profile(rf))[0]
    assert abs(int(profile.argmax()) - 40) <= 1


def test_calibration_offset_is_affine(cfg, rng):
    """Processing calib itself as the raw signal must yield exactly −offset+M·0
    structure: op(calib) == M·calib − M·calib == 0 (up to fp)."""
    op = FastTimeOperator.create(cfg)
    calib = (rng.standard_normal(cfg.nts) + 1j * rng.standard_normal(cfg.nts)
             ).astype(np.complex64)
    raw = np.broadcast_to(calib, (1, cfg.pn, cfg.nts))
    out = from_pair(op(jnp.asarray(to_pair(np.ascontiguousarray(raw))),
                       jnp.asarray(to_pair(calib))))
    assert np.abs(out).max() < 1e-2


def test_packed_bf16_profile_close_to_f32(cfg, rng):
    """bfloat16 matmul inputs: f32-accumulated profile within quantization
    SNR."""
    from fmcw_radar_processing_tpu.dsp.fast_time import PackedFastTime

    frames, calib = make_recording(cfg, num_frames=8, rng=rng)
    raw = jnp.asarray(to_pair(np.swapaxes(frames, -1, -2)))
    calib = jnp.asarray(to_pair(calib))
    f32 = np.asarray(PackedFastTime.create(cfg).profile(raw, calib))
    b16 = np.asarray(
        PackedFastTime.create(cfg, jnp.bfloat16).profile(raw, calib)
    )
    assert b16.dtype == np.float32  # accumulation/output stays f32
    err = np.linalg.norm(b16 - f32) / np.linalg.norm(f32)
    # Zero error would mean XLA's excess-precision folding elided the bf16
    # downcast and the operands silently stayed f32 — the
    # optimization_barrier in PackedFastTime._matmul prevents that.
    assert err > 1e-7, "bf16 cast was folded away — operands stayed f32"
    snr_db = -20 * np.log10(err)
    assert snr_db > 30.0, f"bf16 profile SNR too low: {snr_db:.1f} dB"
