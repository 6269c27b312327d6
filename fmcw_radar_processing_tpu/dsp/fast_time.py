"""Fast-time (range) processing as a single fused matmul.

The reference's fast-time chain (radar_processing.m:201-207) is, per chirp
column x ∈ C^NTS:

    1. calibration subtract + IF scale:   y = (x − calib) · IF_scale      (:203)
    2. per-chirp DC removal:              y ← y − mean(y)                 (:204)
    3. range window:                      y ← y ⊙ 2·blackman(NTS)         (:205)
    4. zero-padded range FFT:             Y = FFT_K(y),  K = 256          (:205)

Every step is linear (or affine) in x, so the whole chain collapses to

    Y = M x − M·(calib·IF_scale),
    M = F_K[:, :NTS] · diag(w) · (I − 11ᵀ/NTS) · IF_scale

one K×NTS complex matrix applied to every chirp of every frame. A
zero-padded 256-point FFT of a 64-sample chirp *is* a 256×64 matrix
multiply, and batching it over (frames · chirps) rows turns the reference's
serial per-frame loop (radar_processing.m:197) into one large matmul with
perfect weight reuse — no FFT butterflies, no per-frame dispatch.

Complex values use the pair convention (utils/cplx.py — trailing [re, im]
axis): the graph contains only real float32 ops. The operator matrix is
built once per configuration on the host in float64 and becomes a
compile-time constant under jit.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from fmcw_radar_processing_tpu.config import RadarConfig
from fmcw_radar_processing_tpu.dsp.windows import blackman
from fmcw_radar_processing_tpu.utils.cplx import pair_abs, pair_matmul


def dft_matrix(k: int, n: int) -> np.ndarray:
    """First ``n`` columns of the K-point DFT matrix (zero-padding operator)."""
    kk = np.arange(k)[:, None]
    nn = np.arange(n)[None, :]
    return np.exp(-2j * np.pi * kk * nn / k)


def build_fast_time_matrix(cfg: RadarConfig) -> np.ndarray:
    """M = F_K[:, :NTS] · diag(2·blackman) · (I − 11ᵀ/NTS) · IF_scale."""
    nts = cfg.nts
    k = cfg.range_fft_size
    w = 2.0 * blackman(nts)
    demean = np.eye(nts) - np.full((nts, nts), 1.0 / nts)
    m = dft_matrix(k, nts) @ np.diag(w) @ demean * cfg.derived.if_scale
    return m.astype(np.complex128)


@dataclasses.dataclass(frozen=True)
class FastTimeOperator:
    """Precomputed fused fast-time operator for a fixed RadarConfig.

    Matrices are host NumPy — trace-time constants baked into the HLO.
    Call with raw chirps laid out as [..., PN, NTS, 2] (chirps along the
    third-to-last axis, ADC samples next, [re, im] pair last — contraction
    axis innermost of the data axes). Returns range FFT [..., PN, K, 2].
    """

    m_re: np.ndarray  # (K, NTS) float32
    m_im: np.ndarray  # (K, NTS) float32

    @classmethod
    def create(cls, cfg: RadarConfig) -> "FastTimeOperator":
        m = build_fast_time_matrix(cfg)
        return cls(m_re=m.real.astype(np.float32), m_im=m.imag.astype(np.float32))

    def offset(self, calib: jax.Array) -> jax.Array:
        """M @ calib (the affine part). calib: [NTS, 2] pair → [K, 2]."""
        return pair_matmul(
            calib, jnp.asarray(self.m_re), jnp.asarray(self.m_im), "n,kn->k"
        )

    def __call__(self, raw: jax.Array, calib: jax.Array) -> jax.Array:
        """Apply the fused chain.

        raw:   [..., PN, NTS, 2] float32 ADC sample pairs (rx1 of tx1,
               matching matrix_raw_data(:,:,1) at radar_processing.m:202),
               or flat pair-rows [..., PN, 2·NTS] (re-paired here; the
               packed operator is the layout-lean path — see
               PackedFastTime._flat_rows).
        calib: [NTS, 2] calibration pair (radar_processing.m:174).
        returns range_fft [..., PN, K, 2] float32.
        """
        nts = self.m_re.shape[1]
        if raw.shape[-1] == 2 * nts:
            raw = raw.reshape(*raw.shape[:-1], nts, 2)
        y = pair_matmul(
            raw.astype(jnp.float32),
            jnp.asarray(self.m_re),
            jnp.asarray(self.m_im),
            "...pn,kn->...pk",
        )
        return y - self.offset(calib.astype(jnp.float32))


@dataclasses.dataclass(frozen=True)
class PackedFastTime:
    """Fast-time operator as ONE real matmul (the memory-lean formulation).

    The 4-einsum complex contraction (`pair_matmul`) reads the de-interleaved
    re/im planes separately and re-interleaves the result — several extra
    passes over the [F, PN, K, 2] tensor. Packing the complex 2×2 block
    structure into a single [2·NTS, 2·K] real weight keeps the pair layout
    intact end to end:

        X [rows, 2n+(0|1)] = (re|im) of sample n      (raw reshaped, no copy)
        W [2n+0, 2k+0] =  M.re[k,n]    W [2n+0, 2k+1] = M.im[k,n]
        W [2n+1, 2k+0] = −M.im[k,n]    W [2n+1, 2k+1] = M.re[k,n]
        Y = X @ W  →  Y [rows, 2k+(0|1)] = (re|im) of bin k   (reshape → pair)

    One matmul, one read of X, one write of Y. `profile()` returns only the
    integrated range profile (detection's input): the chirp max reads the
    product back once and the [F, PN, K, 2] range-FFT tensor is never
    returned; `rf_at_bins()` then recomputes the few detected bins' chirp
    rows with a gathered-weight matmul (T·2 columns instead of K·2) —
    recompute over materialize.
    """

    w: np.ndarray  # (2·NTS, 2·K) float32 packed weight
    nts: int
    k: int
    # Input dtype of the DFT matmul. float32 (default) is exact when paired
    # with precision="highest"; bfloat16 halves the bytes of the dominant
    # operand — accumulation stays float32 (preferred_element_type), so
    # only the 8-bit-mantissa quantization of inputs/weights is lost.
    compute_dtype: jnp.dtype = jnp.float32
    # matmul_precision name for the f32 path (utils/cplx.mxu_precision).
    # Ignored for bf16 inputs.
    precision: str = "highest"

    @classmethod
    def create(
        cls, cfg: RadarConfig, compute_dtype: jnp.dtype = jnp.float32,
        precision: str | None = None,
    ) -> "PackedFastTime":
        m = build_fast_time_matrix(cfg)  # (K, NTS) complex
        k, nts = m.shape
        w = np.zeros((2 * nts, 2 * k), np.float32)
        w[0::2, 0::2] = m.real.T
        w[0::2, 1::2] = m.imag.T
        w[1::2, 0::2] = -m.imag.T
        w[1::2, 1::2] = m.real.T
        if precision is None:
            precision = cfg.algorithm.matmul_precision
        return cls(w=w, nts=nts, k=k, compute_dtype=compute_dtype,
                   precision=precision)

    @property
    def _prec(self):
        from fmcw_radar_processing_tpu.utils.cplx import mxu_precision

        return mxu_precision(self.precision)

    def _matmul(self, x: jax.Array) -> jax.Array:
        """x [..., 2·NTS] @ W, inputs in compute_dtype, f32 accumulate.

        The downcasts are wrapped in ``optimization_barrier``: XLA's
        excess-precision folding otherwise elides a convert(f32→bf16)
        feeding an f32-accumulating dot (the operand is silently kept in
        f32) — measured err vs f32 was exactly 0 without the barrier, i.e.
        neither the quantization nor the bf16 rate benefit was real.
        """
        w = jnp.asarray(self.w)
        if self.compute_dtype != jnp.float32:
            x = jax.lax.optimization_barrier(x.astype(self.compute_dtype))
            w = jax.lax.optimization_barrier(w.astype(self.compute_dtype))
            return jnp.matmul(x, w, preferred_element_type=jnp.float32)
        return jnp.matmul(x, w, preferred_element_type=jnp.float32,
                          precision=self._prec)

    def offset(self, calib: jax.Array) -> jax.Array:
        """M @ calib as a pair [K, 2] (the affine calibration part).

        Always float32 at full precision — it is a single [1, 2K] vector;
        quantizing it would bias every bin for zero bandwidth savings.
        """
        flat = calib.astype(jnp.float32).reshape(1, 2 * self.nts)
        return jnp.matmul(
            flat, jnp.asarray(self.w),
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(self.k, 2)

    def _flat_rows(self, raw: jax.Array) -> jax.Array:
        """Normalize raw chirps to flat pair-rows [..., 2·NTS].

        Accepts [..., NTS, 2] (pair layout) or [..., 2·NTS] (flat). Callers
        that own the host buffer reshape there (a free view) and pass
        [..., 2·NTS], so no in-graph relayout is needed.
        """
        if raw.shape[-1] == 2 * self.nts:
            return raw.astype(jnp.float32)
        return raw.astype(jnp.float32).reshape(*raw.shape[:-2], 2 * self.nts)

    def rf(self, raw: jax.Array, calib: jax.Array) -> jax.Array:
        """Full range FFT [..., PN, K, 2] via one matmul."""
        x = self._flat_rows(raw)
        y = self._matmul(x).reshape(*x.shape[:-1], self.k, 2)
        return y - self.offset(calib)

    def profile(self, raw: jax.Array, calib: jax.Array) -> jax.Array:
        """Integrated range profile [..., K] (abs-max over chirps,
        radar_processing.m:205,210). XLA writes the [..., PN, 2K] matmul
        product and reads it back for the max."""
        y = self.rf(raw, calib)
        return jnp.max(
            jnp.sqrt(y[..., 0] ** 2 + y[..., 1] ** 2), axis=-2
        )

    def rf_at_bins(
        self, raw: jax.Array, calib: jax.Array, idx: jax.Array
    ) -> jax.Array:
        """Range-FFT chirp rows at selected bins only: [F, PN, T, 2].

        raw: [F, PN, NTS, 2]; idx: [F, T] range-bin indices. Gathers the
        2·T weight columns per frame (tiny) and recomputes — never touches
        a [F, PN, K, 2] tensor.
        """
        f, t = idx.shape
        x = self._flat_rows(raw).reshape(f, -1, 2 * self.nts)  # [F,PN,2NTS]
        cols = (idx[..., None] * 2 + jnp.arange(2)).reshape(f, 2 * t)
        w_sel = jnp.asarray(self.w).T[cols]  # [F, 2T, 2NTS]
        y = jnp.einsum("fpn,ftn->fpt", x, w_sel,
                       precision=self._prec)  # [F, PN, 2T]
        y = y.reshape(f, x.shape[1], t, 2)
        off = self.offset(calib)[idx]  # [F, T, 2]
        return y - off[:, None]


def range_profile(range_fft: jax.Array) -> jax.Array:
    """Non-coherent integration across chirps (radar_processing.m:210).

    MATLAB's ``abs(max(X, [], 2))`` on a complex array picks, per range bin,
    the chirp whose FFT value has the largest magnitude, then takes its
    magnitude — which equals the max of magnitudes.

    range_fft: [..., PN, K, 2] → profile [..., K] float32.
    """
    return jnp.max(pair_abs(range_fft), axis=-2)
