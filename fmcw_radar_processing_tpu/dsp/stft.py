"""STFT / micro-Doppler spectrogram as a framed matmul.

The reference computes (radar_processing.m:270-299):

    iq   = abs(slow_time_signal)                     # real, length L  (:270)
    nfft = 2^nextpow2(L)                             # (:273)
    [S,F,T,P] = spectrogram(iq, kaiser(20,3), 19, nfft, 1/PRT)  # hop = 1 (:276)
    F, P = fftshift(F), fftshift(P, 1)               # (:279-280)
    psd  = 20·log10(P / max(P(:)))                   # (:282-283)
    1024 log-spaced bins + linear interp             # (:291-299)

Formulation: each STFT column is the zero-padded FFT of a 20-sample
windowed segment, i.e. S[:, t] = A·x[t : t+20] with A = F_nfft[:nb, :20] ·
diag(kaiser(20, 3)) — so the whole spectrogram is ONE (nb × 20) × (20 × T)
matmul over the sliding-window frame matrix. Since only the PSD is needed,
we compute |S|² = (A_re X)² + (A_im X)² from one stacked real matmul, never
materializing complex values.

Faithfulness notes (SURVEY Appendix A #3/#4):
  * The input is the *magnitude* of the complex slow-time signal — a real
    signal — so MATLAB returns a one-sided spectrogram (nb = nfft/2 + 1).
  * The reference's fftshift of a one-sided F/P produces a non-monotonic
    frequency vector; MATLAB's interp1 then re-sorts its sample points, so
    the shift is a *no-op* for the exported JSON. We therefore keep the
    monotonic one-sided layout (bit-identical output, no permutation).
  * PSD scaling follows MATLAB: |S|²/(fs·Σw²), doubled at all bins except
    DC and (for even nfft) Nyquist. The reference's 20·log10 of a *power*
    quantity (rather than 10·log10) is replicated as-is.
  * hop=1 / nfft=2^nextpow2(L) are the reference defaults; both generalize
    via AlgorithmConfig.stft_hop / stft_nfft.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from fmcw_radar_processing_tpu.dsp.windows import kaiser


class SpectrogramResult(NamedTuple):
    power: jax.Array  # [..., nb, T] float32 linear PSD (invalid columns zeroed)
    frame_valid: jax.Array  # [..., T] bool — columns within the valid signal
    freqs: jax.Array  # [nb] float32 one-sided frequency axis (Hz)
    times: jax.Array  # [T] float32 segment-center times (s)


def stft_frame_count(length: int, window_length: int, hop: int) -> int:
    """Number of STFT columns for a length-L signal (MATLAB fix((L−o)/(w−o)))."""
    if length < window_length:
        return 0
    return (length - window_length) // hop + 1


@dataclasses.dataclass(frozen=True)
class StftOperator:
    """Precomputed framed-matmul STFT for fixed (window, nfft, fs, hop)."""

    a_re: np.ndarray  # (nb, W) float32 — host constant (see fast_time)
    a_im: np.ndarray  # (nb, W) float32
    window_length: int
    nfft: int
    hop: int
    fs: float
    scale: float  # 1 / (fs · Σw²)
    # matmul_precision name for the framed matmul (utils/cplx.mxu_precision).
    precision: str = "highest"

    @classmethod
    def create(
        cls, *, window_length: int = 20, beta: float = 3.0, nfft: int,
        fs: float, hop: int = 1, precision: str = "highest",
    ) -> "StftOperator":
        w = kaiser(window_length, beta)
        nb = nfft // 2 + 1
        kk = np.arange(nb)[:, None]
        nn = np.arange(window_length)[None, :]
        a = np.exp(-2j * np.pi * kk * nn / nfft) * w[None, :]
        return cls(
            a_re=a.real.astype(np.float32),
            a_im=a.imag.astype(np.float32),
            window_length=window_length,
            nfft=nfft,
            hop=hop,
            fs=float(fs),
            scale=float(1.0 / (fs * np.sum(w**2))),
            precision=precision,
        )

    @property
    def num_bins(self) -> int:
        return self.nfft // 2 + 1

    def frame_signal(self, x: jax.Array) -> jax.Array:
        """Sliding-window frame matrix: [..., L] → [..., W, T].

        Built as W hop-strided slices — XLA turns these into cheap views/
        copies; no gather needed because the window length is a small static
        constant.
        """
        t = stft_frame_count(x.shape[-1], self.window_length, self.hop)
        cols = [
            jax.lax.slice_in_dim(x, n, n + (t - 1) * self.hop + 1, self.hop, axis=-1)
            for n in range(self.window_length)
        ]
        return jnp.stack(cols, axis=-2)

    def __call__(
        self, x: jax.Array, valid_len: jax.Array | None = None
    ) -> SpectrogramResult:
        """Compute the one-sided PSD spectrogram of a real signal.

        x: [..., L] float32 (already |·| of the slow-time signal).
        valid_len: optional scalar/batched count of valid samples in x; STFT
          columns extending past it are masked out (fixed-capacity idiom).
        """
        from fmcw_radar_processing_tpu.utils.cplx import mxu_precision

        prec = mxu_precision(self.precision)
        frames = self.frame_signal(x.astype(jnp.float32))  # [..., W, T]
        # ONE stacked matmul for re and im: A2 = [a_re; a_im] (2nb, W).
        # Identical per-row arithmetic to two separate einsums (bit-exact),
        # but the hop-1 frame matrix, the second-largest tensor of the
        # chain, is read once instead of twice.
        a2 = jnp.asarray(np.concatenate([self.a_re, self.a_im], axis=0))
        s2 = jnp.einsum("bw,...wt->...bt", a2, frames, precision=prec)
        nb_ = self.num_bins
        s_re = s2[..., :nb_, :]
        s_im = s2[..., nb_:, :]
        p = (s_re * s_re + s_im * s_im) * jnp.float32(self.scale)
        # One-sided doubling: every bin except DC and (even nfft) Nyquist.
        nb = self.num_bins
        dbl = np.full(nb, 2.0, np.float32)
        dbl[0] = 1.0
        if self.nfft % 2 == 0:
            dbl[-1] = 1.0
        p = p * jnp.asarray(dbl)[:, None]

        t = p.shape[-1]
        if valid_len is None:
            frame_valid = jnp.ones(x.shape[:-1] + (t,), bool)
        else:
            n_valid = (jnp.asarray(valid_len) - self.window_length) // self.hop + 1
            frame_valid = jnp.arange(t) < n_valid[..., None]
            p = jnp.where(frame_valid[..., None, :], p, 0.0)

        freqs = jnp.arange(nb, dtype=jnp.float32) * jnp.float32(self.fs / self.nfft)
        times = (
            jnp.arange(t, dtype=jnp.float32) * self.hop + self.window_length / 2.0
        ) / jnp.float32(self.fs)
        return SpectrogramResult(power=p, frame_valid=frame_valid,
                                 freqs=freqs, times=times)


DB_FLOOR = -1000.0
"""dB floor standing in for MATLAB's −inf at P = 0 (radar_processing.m:283).

−1000 dB is far below any representable float32 power ratio (−758 dB), so
no physical value is affected; a finite floor keeps the downstream
log-frequency rescale expressible as a matmul (−inf · 0 = NaN would poison
it) and keeps payloads JSON-clean.
"""


INT8_DB_RANGE = (-41.0, 1.0)
"""Affine-quantization range for the int8 intensity emission (dB).

Chosen around the reference PNG's clim [−40, 0] (radar_processing.m:340)
with 1 dB of margin on each side: step = 42/255 ≈ 0.1647 dB, so
round-to-nearest error is ≤ 0.0824 dB for any in-range value — within the
≤ 0.15 dB display-band promotion criterion. Values outside the range
clamp; by construction only sub-display (< −41 dB) or above-max (> +1 dB,
impossible after global-max normalization) bins are affected."""


def int8_db_step() -> float:
    lo, hi = INT8_DB_RANGE
    return (hi - lo) / 255.0


def quantize_db_int8(db: jax.Array) -> jax.Array:
    """dB [..., any] float32 → int8 code: round((db − lo)/step) − 128."""
    lo, _ = INT8_DB_RANGE
    q = jnp.clip(jnp.round((db - jnp.float32(lo))
                           * jnp.float32(1.0 / int8_db_step())), 0.0, 255.0)
    return (q - 128.0).astype(jnp.int8)


def decode_db_int8(arr) -> np.ndarray:
    """Host-side inverse of :func:`quantize_db_int8` (int8 codes → dB f32)."""
    lo, _ = INT8_DB_RANGE
    return ((np.asarray(arr, np.float32) + 128.0)
            * np.float32(int8_db_step()) + np.float32(lo))


def psd_db(result: SpectrogramResult) -> jax.Array:
    """Reference dB normalization: 20·log10(P / global_max) over valid columns
    (radar_processing.m:282-283; the G>0 guard of :547-552 maps zeros to the
    floor)."""
    g = jnp.max(result.power, axis=(-2, -1), keepdims=True)
    safe_g = jnp.where(g > 0, g, 1.0)
    return jnp.where(
        result.power > 0,
        jnp.maximum(20.0 * jnp.log10(jnp.maximum(result.power, 1e-45) / safe_g),
                    DB_FLOOR),
        DB_FLOOR,
    )


def log_bins_axis(freqs: jax.Array, num_bins: int = 1024) -> jax.Array:
    """The log-spaced output frequency axis of the rescale (Hz),
    logspace(log10(freqs[1]), log10(freqs[-1]), num_bins)."""
    nb = freqs.shape[0]
    return freqs[1] * jnp.asarray(
        np.logspace(0.0, np.log10(nb - 1), num_bins, dtype=np.float64)
        .astype(np.float32)
    )


@functools.lru_cache(maxsize=32)
def _log_interp_indices(nb: int, num_bins: int):
    """(i0 [num_bins] int32, frac [num_bins] f32) of the log grid.

    The log grid normalized by the bin width is logspace(0, log10(nb−1))
    — independent of df/fs — so each output row interpolates between the
    two fixed input rows i0 and i0 + 1."""
    pos = np.logspace(0.0, np.log10(nb - 1), num_bins)
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, nb - 2)
    frac = (pos - i0).astype(np.float32)
    return i0.astype(np.int32), frac


def log_frequency_rescale(
    freqs: jax.Array, values: jax.Array, num_bins: int = 1024,
) -> tuple[jax.Array, jax.Array]:
    """Log-spaced frequency re-gridding (radar_processing.m:291-299).

    Grid: logspace(log10(min positive freq), log10(max freq), num_bins).
    Because the one-sided axis is uniform (freqs[i] = i·df), the grid lies
    inside [freqs[1], freqs[-1]] ⊂ [freqs[0], freqs[-1]] — MATLAB's
    'extrap' never actually extrapolates — and the interpolation weights
    are static: two static row-gathers and a lerp, exact in f32. (The
    equivalent dense [num_bins, nb] matmul was 3.6× slower on an H100 at
    three TF32 passes, and less exact: PERF.md, Findings.)

    freqs: [nb] uniform axis with freqs[0] = 0; values: [..., nb, T].
    Returns (log_bins [num_bins], interp [..., num_bins, T]).
    """
    nb = freqs.shape[0]
    i0, frac = _log_interp_indices(nb, num_bins)
    lo = jnp.take(values, jnp.asarray(i0), axis=-2)
    hi = jnp.take(values, jnp.asarray(i0 + 1), axis=-2)
    interp = lo + jnp.asarray(frac)[:, None] * (hi - lo)
    return log_bins_axis(freqs, num_bins), interp
