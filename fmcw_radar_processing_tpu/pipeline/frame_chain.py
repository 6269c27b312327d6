"""The per-frame processing chain, batched over a whole recording.

The reference iterates frames serially (radar_processing.m:197-261). Here
the chain is one traced function over the full [F, PN, NTS] recording —
every stage is batched, so XLA sees two large matmuls (range DFT, Doppler
DFT) plus fused elementwise/reduction epilogues, one program for the whole
recording instead of a dispatch per frame.

Variable-length state (the concatenated slow-time signal,
radar_processing.m:255-260) is handled with the fixed-capacity idiom:
chirp rows of detected frames are scatter-packed into a [F·PN] buffer with
a valid count — no dynamic shapes, no host round-trips inside the graph.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from fmcw_radar_processing_tpu.config import RadarConfig
from fmcw_radar_processing_tpu.dsp.detection import DetectionResult, search_peaks
from fmcw_radar_processing_tpu.dsp.fast_time import (
    FastTimeOperator,
    PackedFastTime,
    range_profile,
)
from fmcw_radar_processing_tpu.dsp.slow_time import (
    DopplerPeaks,
    SlowTimeOperator,
    doppler_at_bins,
    doppler_peaks_at,
    measurements,
)
from fmcw_radar_processing_tpu.utils.cplx import pair_matmul


class FrameChainOutputs(NamedTuple):
    """Per-frame chain results for a recording of F frames."""

    waterfall: jax.Array  # [F, K] float32 — abs-max over chirps (:265)
    detection: DetectionResult  # idx/magnitude/valid, each [F, T]
    doppler: DopplerPeaks  # doppler_idx/speed, each [F, T]
    strength: jax.Array  # [T, F] float32, NaN-filled
    range: jax.Array  # [T, F] float32, NaN-filled
    speed: jax.Array  # [T, F] float32, NaN-filled
    strongest_chirps: jax.Array  # [F, PN, 2] float32 pair — range FFT rows
    # at the strongest target's bin (radar_processing.m:258-259); garbage
    # where detected is False
    detected: jax.Array  # [F] bool
    range_fft: jax.Array | None  # [F, PN, K, 2] float32 pair, if requested


def resolve_impl(impl: str) -> str:
    """'auto' → 'fused' on every backend.

    A Pallas-Triton kernel that kept the [F·PN, 2K] product on chip ran the
    profile stage 19% faster on an H100 but left process_recording no
    faster end to end (the host dominates), so it was removed (PERF.md,
    Findings).
    """
    return "fused" if impl == "auto" else impl


def make_frame_chain(
    cfg: RadarConfig, return_range_fft: bool = False, impl: str = "auto"
):
    """Build the jitted recording chain for a fixed config.

    Returns fn(raw [F, PN, NTS, 2], calib [NTS, 2]) -> FrameChainOutputs.
    F is a trace-time constant (one compile per recording length bucket).

    impl:
      'auto'   resolve_impl: 'fused'.
      'fused'  packed single-matmul fast-time (dsp/fast_time.py
               PackedFastTime) followed by the magnitude/chirp-max; chirp
               rows at the T detected bins are recomputed with a
               gathered-weight matmul, so the [F, PN, K, 2] range-FFT
               tensor is never returned.
      'xla'    einsum formulation, full range-FFT materialized.
      'fused_bf16'  fused with bfloat16 matmul inputs (f32 accumulate).
    All impls give the same detections (tests/test_fused_chain.py); the
    bf16 variant is identical up to input quantization.
    """
    impl = resolve_impl(impl)
    if impl not in ("fused", "xla", "fused_bf16"):
        raise ValueError(f"unknown impl {impl!r}")
    ft = FastTimeOperator.create(cfg)
    pft = PackedFastTime.create(
        cfg, jnp.bfloat16 if impl == "fused_bf16" else jnp.float32
    )
    st = SlowTimeOperator.create(cfg)

    @jax.jit
    def chain(raw: jax.Array, calib: jax.Array) -> FrameChainOutputs:
        rf = None
        if impl in ("fused", "fused_bf16") and not return_range_fft:
            profile = pft.profile(raw, calib)  # [F, K]
            det = search_peaks(profile, cfg)  # [F, T]
        else:
            rf = (ft(raw, calib) if impl == "xla"
                  else pft.rf(raw, calib))  # [F, PN, K, 2]
            profile = range_profile(rf)  # [F, K]
            det = search_peaks(profile, cfg)  # [F, T]
        # Doppler only at detected bins (radar_processing.m:216-219): T ≪ K,
        # so the full [F, K, D] map is never materialized.
        if rf is None:
            # Recompute the detected bins' chirp rows: [F, PN, T, 2].
            rf_rows = pft.rf_at_bins(raw, calib, det.idx)
            rows = jnp.swapaxes(rf_rows, -3, -2)  # [F, T, PN, 2]
            rd_rows = pair_matmul(
                rows, jnp.asarray(st.m_re), jnp.asarray(st.m_im),
                "...tp,dp->...td",
            )  # [F, T, D, 2]
            strongest = rf_rows[:, :, 0, :]  # [F, PN, 2]
        else:
            rd_rows = doppler_at_bins(st, rf, det.idx)  # [F, T, D, 2]
            # Chirp row at the strongest detected bin, per frame (:258-259).
            strongest = jnp.take_along_axis(
                rf, det.idx[:, 0][:, None, None, None], axis=-2
            )[..., 0, :]  # [F, PN, 2]
        dop = doppler_peaks_at(rd_rows, cfg)
        meas = measurements(det, dop, cfg)
        return FrameChainOutputs(
            waterfall=profile,
            detection=det,
            doppler=dop,
            strength=meas.strength,
            range=meas.range,
            speed=meas.speed,
            strongest_chirps=strongest,
            detected=det.valid[:, 0],
            range_fft=rf if return_range_fft else None,
        )

    return chain


@functools.partial(jax.jit, static_argnames=("pn",))
def pack_slow_time(
    strongest_chirps: jax.Array, detected: jax.Array, pn: int
) -> tuple[jax.Array, jax.Array]:
    """Concatenate chirp rows of detected frames (radar_processing.m:255-260)
    into a fixed-capacity buffer.

    Frames with no detection are skipped — the slow-time axis "skips" those
    periods by design (:519-522). Packing is a stable partition: sort the F
    frames by (not detected) with original order preserved, gather whole
    chirp rows, zero everything past the valid prefix: a sort of F keys
    and a contiguous [F, PN, 2] row gather, with no F·PN-index scatter.

    Returns (signal [F·PN, 2] float32 pair, valid_count scalar int32).
    """
    f = strongest_chirps.shape[0]
    perm = jnp.argsort(jnp.where(detected, 0, 1).astype(jnp.int32),
                       stable=True)  # detected frames first, in order
    gathered = jnp.take(strongest_chirps.astype(jnp.float32), perm, axis=0)
    n_det = jnp.sum(detected.astype(jnp.int32))
    keep = jnp.arange(f, dtype=jnp.int32) < n_det
    out = jnp.where(keep[:, None, None], gathered, 0.0)
    return out.reshape(f * pn, 2), n_det * pn
