"""Tensor-parallel frame chain: range bins sharded over the ``model`` axis.

The reference has no tensor parallelism (SURVEY §2.3 — the whole chain is a
serial MATLAB loop, radar_processing.m:197). The TP formulation here
shards the *output* axis of the fast-time DFT matmul — the K=256 range bins
(radar_processing.m:118) — across the ``model`` mesh axis:

  * the (K, NTS) fast-time operator matrix is row-sharded, so each device
    computes only its K/mp slice of the range FFT — the dominant-FLOPs
    matmul is split exactly like a column-parallel Dense layer;
  * non-coherent integration (abs-max over chirps, radar_processing.m:210)
    is bin-local, so the integrated profile is computed shard-locally and
    assembled with one ``all_gather`` of K/mp floats per frame — the only
    point where detection needs the full profile (peaks compare neighboring
    bins and take a global top-k);
  * the Doppler stage needs the range-FFT chirp rows *at detected bins
    only* (radar_processing.m:216): every shard contributes its owned rows
    (others contribute zeros) and one ``psum`` over ``model`` materializes
    them everywhere — T·PN values per frame, never the full map.

Per-frame communication is K + T·PN·2 + PN·2 floats — independent of NTS
and of the per-device FLOPs, so TP composes with frame-level data
parallelism on a (data, model) mesh: raw frames shard over ``data``, DFT
rows over ``model``.

Outputs are bit-identical to the single-device chain (the matmul is
partitioned on the reduction-free axis, so no reassociation occurs).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fmcw_radar_processing_tpu.config import RadarConfig
from fmcw_radar_processing_tpu.dsp.detection import DetectionResult, search_peaks
from fmcw_radar_processing_tpu.dsp.fast_time import FastTimeOperator
from fmcw_radar_processing_tpu.dsp.slow_time import (
    DopplerPeaks,
    SlowTimeOperator,
    doppler_peaks_at,
    measurements,
)
from fmcw_radar_processing_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from fmcw_radar_processing_tpu.pipeline.frame_chain import FrameChainOutputs
from fmcw_radar_processing_tpu.utils.cplx import pair_abs, pair_matmul


def make_tp_frame_chain(cfg: RadarConfig, mesh: Mesh):
    """Build the (data, model)-sharded chain for a fixed config.

    Returns fn(raw [F, PN, NTS, 2], calib [NTS, 2]) -> FrameChainOutputs.
    F must divide by the ``data`` axis size and K=range_fft_size by the
    ``model`` axis size.
    """
    mp = mesh.shape[MODEL_AXIS]
    dp = mesh.shape[DATA_AXIS]
    k = cfg.range_fft_size
    if k % mp != 0:
        raise ValueError(f"range_fft_size {k} not divisible by model axis {mp}")
    kloc = k // mp
    ft = FastTimeOperator.create(cfg)
    st = SlowTimeOperator.create(cfg)
    st_re = jnp.asarray(st.m_re)
    st_im = jnp.asarray(st.m_im)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, None, None, None),  # raw frames
            P(),  # calib (replicated)
            P(MODEL_AXIS, None),  # fast-time matrix rows (real)
            P(MODEL_AXIS, None),  # fast-time matrix rows (imag)
        ),
        out_specs=FrameChainOutputs(
            waterfall=P(DATA_AXIS, None),
            detection=DetectionResult(
                idx=P(DATA_AXIS, None),
                magnitude=P(DATA_AXIS, None),
                valid=P(DATA_AXIS, None),
            ),
            doppler=DopplerPeaks(
                doppler_idx=P(DATA_AXIS, None), speed=P(DATA_AXIS, None)
            ),
            strength=P(None, DATA_AXIS),
            range=P(None, DATA_AXIS),
            speed=P(None, DATA_AXIS),
            strongest_chirps=P(DATA_AXIS, None, None),
            detected=P(DATA_AXIS),
            range_fft=None,
        ),
        check_vma=False,
    )
    def run(raw, calib, m_re_l, m_im_l):
        # Shard-local slice of the fused fast-time matmul: rows of M are
        # this shard's K/mp range bins (fast_time.build_fast_time_matrix).
        rf_l = pair_matmul(
            raw.astype(jnp.float32), m_re_l, m_im_l, "...pn,kn->...pk"
        ) - pair_matmul(calib.astype(jnp.float32), m_re_l, m_im_l, "n,kn->k")
        # Bin-local non-coherent integration (radar_processing.m:210), then
        # one tiny all_gather assembles the K-bin profile on every shard.
        profile_l = jnp.max(pair_abs(rf_l), axis=-2)  # [f, kloc]
        profile = jax.lax.all_gather(
            profile_l, MODEL_AXIS, axis=-1, tiled=True
        )  # [f, K]
        det = search_peaks(profile, cfg)

        # Doppler rows at detected bins: the owning shard contributes its
        # range-FFT chirp row, everyone else zeros; psum materializes the
        # [f, T, PN, 2] rows on all shards (radar_processing.m:216-219).
        off = jax.lax.axis_index(MODEL_AXIS) * kloc
        lidx = det.idx - off
        owned = (lidx >= 0) & (lidx < kloc)  # [f, T]
        lidx_c = jnp.clip(lidx, 0, kloc - 1)
        gathered = jnp.take_along_axis(
            rf_l, lidx_c[..., None, :, None], axis=-2
        )  # [f, PN, T, 2]
        rows = jnp.swapaxes(gathered, -3, -2)  # [f, T, PN, 2]
        rows = jnp.where(owned[..., None, None], rows, 0.0)
        rows = jax.lax.psum(rows, MODEL_AXIS)

        rd_rows = pair_matmul(rows, st_re, st_im, "...tp,dp->...td")
        dop = doppler_peaks_at(rd_rows, cfg)
        meas = measurements(det, dop, cfg)
        return FrameChainOutputs(
            waterfall=profile,
            detection=det,
            doppler=dop,
            strength=meas.strength,
            range=meas.range,
            speed=meas.speed,
            strongest_chirps=rows[:, 0],  # strongest target's chirp row
            detected=det.valid[:, 0],
            range_fft=None,
        )

    raw_sharding = NamedSharding(mesh, P(DATA_AXIS, None, None, None))
    replicated = NamedSharding(mesh, P())

    @functools.partial(jax.jit, in_shardings=(raw_sharding, replicated))
    def chain(raw: jax.Array, calib: jax.Array) -> FrameChainOutputs:
        return run(raw, calib, jnp.asarray(ft.m_re), jnp.asarray(ft.m_im))

    return chain
