"""Range target detection: vectorized peak search.

Replaces the reference's external Infineon ``f_search_peak`` (called at
radar_processing.m:211 with (profile, len, range_threshold, max_num_targets,
min_distance, max_distance, dist_per_bin); the library itself is not in the
repo). Defined semantics, consistent with every call-site constraint in the
reference:

  * only bins whose range (0-based bin · dist_per_bin, cf. the
    ``(tgt_range_idx − 1) · dist_per_bin`` mapping at radar_processing.m:248)
    lies in [min_distance, max_distance] are eligible;
  * a bin is a peak if it is a local maximum of the profile (≥ both
    neighbors) and its magnitude exceeds range_threshold;
  * up to ``max_num_targets`` peaks are returned strongest-first — the
    reference treats ``tgt_range_idx(1)`` as "index of strongest target"
    (radar_processing.m:258,514), which pins the ordering.

The reference branches on ``num_of_targets`` with data-dependent control
flow (radar_processing.m:213-260). Under jit that is poison, so detection
returns fixed-capacity (T = max_num_targets) index/magnitude arrays plus a
validity mask — the masked-capacity idiom that keeps every downstream shape
static and XLA-fusible.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fmcw_radar_processing_tpu.config import RadarConfig


class DetectionResult(NamedTuple):
    idx: jax.Array  # [..., T] int32 — 0-based range-bin indices, strongest first
    magnitude: jax.Array  # [..., T] float32 — profile value at each peak
    valid: jax.Array  # [..., T] bool — which capacity slots hold real targets

    @property
    def num_targets(self) -> jax.Array:
        return jnp.sum(self.valid, axis=-1)


def gate_mask(cfg: RadarConfig) -> jnp.ndarray:
    """Static per-bin eligibility mask from the distance gate."""
    k = cfg.range_fft_size
    dist = jnp.arange(k, dtype=jnp.float32) * cfg.derived.dist_per_bin
    return (dist >= cfg.algorithm.min_distance) & (dist <= cfg.algorithm.max_distance)


def search_peaks(profile: jax.Array, cfg: RadarConfig) -> DetectionResult:
    """Vectorized f_search_peak over arbitrary leading batch dims.

    profile: [..., K] float32 integrated range profile.
    """
    neg = jnp.float32(-jnp.inf)
    left = jnp.pad(profile[..., :-1], [(0, 0)] * (profile.ndim - 1) + [(1, 0)],
                   constant_values=-jnp.inf)
    right = jnp.pad(profile[..., 1:], [(0, 0)] * (profile.ndim - 1) + [(0, 1)],
                    constant_values=-jnp.inf)
    is_peak = (profile >= left) & (profile >= right)
    eligible = (
        is_peak
        & gate_mask(cfg)
        & (profile > cfg.algorithm.range_threshold)
    )
    masked = jnp.where(eligible, profile, neg)
    t = cfg.algorithm.max_num_targets
    if t == 1:
        # One target: argmax, a plain reduction, instead of top_k's sort.
        # The magnitude at the argmax IS the max — a second reduction that
        # fuses into the same pass, not a row gather.
        idx = jnp.argmax(masked, axis=-1)[..., None]
        mag = jnp.max(masked, axis=-1)[..., None]
    else:
        mag, idx = jax.lax.top_k(masked, t)
    valid = jnp.isfinite(mag)
    return DetectionResult(
        idx=idx.astype(jnp.int32),
        magnitude=jnp.where(valid, mag, 0.0),
        valid=valid,
    )
