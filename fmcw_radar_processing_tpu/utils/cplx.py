"""Complex-as-pair arithmetic: complex values as a trailing length-2 axis.

The device compute path contains NO complex dtypes: every complex
quantity is a float32 array with a trailing [re, im] axis. Reasons:

  * complex matmuls lower to real-matmul sequences anyway — doing it
    explicitly packs the complex 2×2 block structure into one real weight
    (dsp/fast_time.PackedFastTime), one real GEMM per stage;
  * the magnitude-only consumers (detection, STFT input) never need the
    full complex product.

Host-side conversion helpers bridge to NumPy complex at the I/O boundary.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def to_pair(x) -> np.ndarray | jax.Array:
    """complex array → [..., 2] float32 pair (NumPy in, NumPy out)."""
    if isinstance(x, np.ndarray):
        if np.iscomplexobj(x):
            return np.stack([x.real, x.imag], axis=-1).astype(np.float32)
        return np.stack([x, np.zeros_like(x)], axis=-1).astype(np.float32)
    if jnp.iscomplexobj(x):
        return jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1).astype(jnp.float32)
    return jnp.stack([x, jnp.zeros_like(x)], axis=-1).astype(jnp.float32)


def from_pair(x) -> np.ndarray:
    """[..., 2] pair → NumPy complex (host side, for tests/IO)."""
    a = np.asarray(x)
    return a[..., 0] + 1j * a[..., 1]


def pair_abs(x: jax.Array) -> jax.Array:
    """|z| of a pair array: [..., 2] → [...]."""
    return jnp.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])


def mxu_precision(name: str):
    """Map a matmul_precision name to what an f32 dot runs as.

    On an NVIDIA GPU (Hopper):
      "default" — ``Precision.DEFAULT``: one TF32 tensor-core pass (operands
                  rounded to a 10-bit mantissa, f32 accumulate).
      "high"    — ``DotAlgorithmPreset.TF32_TF32_F32_X3``: three TF32 passes
                  (each operand split hi + lo), about 2^-21 relative. Set
                  explicitly so the meaning does not depend on how a
                  backend reads ``Precision.HIGH``.
      "highest" — ``Precision.HIGHEST``: full f32, off the tensor cores.
    The CPU backend computes every f32 dot in f32 and has no TF32 algorithm,
    so there each name maps to its ``Precision`` enum.
    """
    try:
        prec = {
            "default": jax.lax.Precision.DEFAULT,
            "high": jax.lax.Precision.HIGH,
            "highest": jax.lax.Precision.HIGHEST,
        }[name]
    except KeyError:
        raise ValueError(
            f"unknown matmul precision {name!r} "
            f"(expected default|high|highest)"
        ) from None
    if name == "high" and jax.default_backend() == "gpu":
        return jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3
    return prec


def pair_matmul(
    x: jax.Array, m_re: jax.Array, m_im: jax.Array, spec: str,
    precision: str = "highest",
) -> jax.Array:
    """Complex contraction of a pair array with a constant complex matrix.

    x: [..., 2] pair operand; m_re/m_im: real/imag parts of the matrix;
    spec: einsum spec for ONE real contraction (e.g. '...pn,kn->...pk').
    Returns the pair result [..., 2] via 4 real einsums (XLA fuses the
    adds; the matrices are trace-time constants so CSE shares operands).
    Defaults to full f32 — pair_matmul sits on fidelity paths.
    """
    prec = mxu_precision(precision)
    xr, xi = x[..., 0], x[..., 1]
    yr = (jnp.einsum(spec, xr, m_re, precision=prec)
          - jnp.einsum(spec, xi, m_im, precision=prec))
    yi = (jnp.einsum(spec, xr, m_im, precision=prec)
          + jnp.einsum(spec, xi, m_re, precision=prec))
    return jnp.stack([yr, yi], axis=-1)
