"""Slow-time (Doppler) processing and target speed extraction.

The reference computes the Doppler FFT only at detected range bins with a
data-dependent gather/mutate (radar_processing.m:216-219):

    1. per-bin mean removal across chirps (clutter/DC removal)     (:217-218)
    2. Chebyshev window across chirps                              (:219)
    3. 16-point FFT across chirps + fftshift                       (:219)

``SlowTimeOperator`` computes the *full* range-Doppler map: all three steps
are linear along the chirp axis, so they fold into one PN→D complex matrix

    A = S_shift · F_D · P_pad/trunc · diag(chebwin) · (I − 11ᵀ/PN)

and the map is one batched matmul  RD[..., K, D] = Yᵀ A ᵀ.  Computing all
256 bins as one matmul avoids a data-dependent gather and dynamic shapes;
values at detected bins are identical to the reference's because the
per-bin operations don't couple bins.

Doppler peak extraction (radar_processing.m:227-239): argmax of |RD| over
Doppler bins at each detected range bin; accept iff value ≥
Doppler_threshold and the bin is not the zero-velocity bin (1-based bin 9
for D=16 — the DC bin after fftshift, derived here as D//2 0-based);
otherwise the target is assigned zero speed.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from fmcw_radar_processing_tpu.config import RadarConfig
from fmcw_radar_processing_tpu.dsp.detection import DetectionResult
from fmcw_radar_processing_tpu.dsp.windows import chebwin
from fmcw_radar_processing_tpu.utils.cplx import pair_abs, pair_matmul


def build_slow_time_matrix(cfg: RadarConfig) -> np.ndarray:
    """A = S_shift · F_D · P · diag(2·chebwin(PN)) · (I − 11ᵀ/PN),  (D, PN).

    P handles MATLAB fft(x, D) length adaptation: truncation to the first D
    windowed chirps when PN > D, implicit zero-padding when PN < D
    (radar_processing.m:219 applies the window before the FFT, so the window
    covers all PN chirps while the FFT consumes min(PN, D) of them).
    """
    pn = cfg.pn
    d = cfg.doppler_fft_size
    w = 2.0 * chebwin(pn)
    demean = np.eye(pn) - np.full((pn, pn), 1.0 / pn)
    # F_D · P: (D, PN) — column p contributes exp(-2πi p d / D) iff p < D.
    dd = np.arange(d)[:, None]
    pp = np.arange(pn)[None, :]
    fmat = np.where(pp < d, np.exp(-2j * np.pi * dd * pp / d), 0.0)
    a = fmat @ np.diag(w) @ demean
    # fftshift along the Doppler axis: output row i takes DFT row (i + D//2) % D.
    shift = (np.arange(d) + d // 2) % d
    return a[shift].astype(np.complex128)


@dataclasses.dataclass(frozen=True)
class SlowTimeOperator:
    """Fused Doppler operator: range_fft [..., PN, K, 2] → RD map
    [..., K, D, 2] (pair convention, utils/cplx.py)."""

    m_re: np.ndarray  # (D, PN) float32 — host constant (see fast_time)
    m_im: np.ndarray  # (D, PN) float32

    @classmethod
    def create(cls, cfg: RadarConfig) -> "SlowTimeOperator":
        m = build_slow_time_matrix(cfg)
        return cls(m_re=m.real.astype(np.float32), m_im=m.imag.astype(np.float32))

    def __call__(self, range_fft: jax.Array) -> jax.Array:
        return pair_matmul(
            range_fft.astype(jnp.float32),
            jnp.asarray(self.m_re),
            jnp.asarray(self.m_im),
            "...pk,dp->...kd",
        )


class DopplerPeaks(NamedTuple):
    doppler_idx: jax.Array  # [..., T] int32, 0-based fftshifted Doppler bin
    speed: jax.Array  # [..., T] float32 m/s (0 for rejected/zero-velocity)


def doppler_at_bins(
    op: "SlowTimeOperator", range_fft: jax.Array, idx: jax.Array
) -> jax.Array:
    """Doppler spectra at selected range bins only.

    The reference computes the Doppler FFT solely at detected bins
    (radar_processing.m:216-219); for T = max_num_targets ≪ K this gathered
    form does T/K of the full-map work and never materializes the
    [F, K, D, 2] cube in device memory.

    range_fft: [..., PN, K, 2]; idx: [..., T] range-bin indices.
    Returns rd rows [..., T, D, 2].
    """
    # Gather rows: [..., PN, T, 2] → transpose PN/T → matmul over PN.
    gathered = jnp.take_along_axis(
        range_fft, idx[..., None, :, None], axis=-2
    )  # [..., PN, T, 2]
    rows = jnp.swapaxes(gathered, -3, -2)  # [..., T, PN, 2]
    return pair_matmul(
        rows, jnp.asarray(op.m_re), jnp.asarray(op.m_im), "...tp,dp->...td"
    )


def doppler_peaks_at(
    rd_rows: jax.Array, cfg: RadarConfig
) -> DopplerPeaks:
    """Peak extraction from per-target Doppler rows [..., T, D, 2]
    (radar_processing.m:227-239 semantics, same as doppler_peaks)."""
    zero_bin = cfg.zero_doppler_bin
    rows = pair_abs(rd_rows)  # [..., T, D]
    dop_idx = jnp.argmax(rows, axis=-1).astype(jnp.int32)
    val = jnp.max(rows, axis=-1)
    accept = (val >= cfg.algorithm.doppler_threshold) & (dop_idx != zero_bin)
    dop_idx = jnp.where(accept, dop_idx, zero_bin)
    speed = (
        (dop_idx - zero_bin).astype(jnp.float32)
        * jnp.float32(-cfg.derived.fd_per_bin * cfg.derived.hz_to_mps)
    )
    return DopplerPeaks(doppler_idx=dop_idx, speed=speed)


def doppler_peaks(
    rd_map: jax.Array, detection: DetectionResult, cfg: RadarConfig
) -> DopplerPeaks:
    """Extract per-target Doppler bin + speed from the range-Doppler map.

    rd_map: [..., K, D, 2] pair; detection.idx: [..., T].
    """
    zero_bin = cfg.zero_doppler_bin
    # Gather the Doppler rows of the detected range bins: [..., T, D].
    rows = jnp.take_along_axis(
        pair_abs(rd_map), detection.idx[..., None], axis=-2
    )
    dop_idx = jnp.argmax(rows, axis=-1).astype(jnp.int32)
    val = jnp.max(rows, axis=-1)
    accept = (val >= cfg.algorithm.doppler_threshold) & (dop_idx != zero_bin)
    dop_idx = jnp.where(accept, dop_idx, zero_bin)
    # speed = (bin1 − D/2 − 1) · (−fD_per_bin) · λ/2 with 1-based bin1
    #       = (idx0 − zero_bin) · (−fD_per_bin) · λ/2   (radar_processing.m:250)
    speed = (
        (dop_idx - zero_bin).astype(jnp.float32)
        * jnp.float32(-cfg.derived.fd_per_bin * cfg.derived.hz_to_mps)
    )
    return DopplerPeaks(doppler_idx=dop_idx, speed=speed)


class TargetMeasurements(NamedTuple):
    """Per-frame target track (radar_processing.m:156-159, 499-528).

    Layout is (target, frame) — the 'yes'-branch convention, which matches
    the allocation; the 'no' branch's transposed indexing
    (radar_processing.m:245-250) is a documented reference bug (SURVEY
    Appendix A #1) that we do not replicate. Missing targets are NaN, the
    'yes'-branch convention (:507-509, :525-527).
    """

    strength: jax.Array  # [T, F] float32, NaN where invalid
    range: jax.Array  # [T, F] float32 metres, NaN where invalid
    speed: jax.Array  # [T, F] float32 m/s, NaN where invalid


def measurements(
    detection: DetectionResult, peaks: DopplerPeaks, cfg: RadarConfig
) -> TargetMeasurements:
    """Assemble measurements from per-frame detections.

    detection/peaks have shape [F, T]; output arrays are [T, F].
    """
    nan = jnp.float32(jnp.nan)
    strength = jnp.where(detection.valid, detection.magnitude, nan).T
    rng = jnp.where(
        detection.valid,
        detection.idx.astype(jnp.float32) * jnp.float32(cfg.derived.dist_per_bin),
        nan,
    ).T
    speed = jnp.where(detection.valid, peaks.speed, nan).T
    return TargetMeasurements(strength=strength, range=rng, speed=speed)
