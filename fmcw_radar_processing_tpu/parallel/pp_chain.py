"""Pipeline-parallel frame chain: chain stages sharded across devices.

The reference has no pipeline parallelism (SURVEY §2.3 — its whole chain is
one serial MATLAB loop, radar_processing.m:197). This module stages the
chain across a ``stage`` mesh axis: a GPipe-style microbatch rotation
inside ``shard_map``, with `lax.ppermute` moving each microbatch's
activations one stage to the right each tick.

Stage partition (2 stages — the chain's two matmul-dominated halves):

  stage 0  fast-time: calibration + DC removal + window + range-DFT matmul
           (radar_processing.m:201-207 semantics)         → rf [mb, PN, K, 2]
  stage 1  detect + Doppler-at-bins matmul + measurements + strongest-bin
           extraction (radar_processing.m:210-259 semantics)

Schedule: M microbatches over M+1 ticks. At tick t, stage 0 transforms
microbatch t (t < M) while stage 1 consumes microbatch t−1 (t ≥ 1) — both
matmuls run concurrently on different devices from tick 1 onward. Outputs
accumulate on the last stage and are replicated with one `psum` (the other
stages contribute zeros). The ``stage`` axis composes with the ``data``
axis: frames shard over ``data`` and each data-shard pipelines over
``stage``.

Pipeline parallelism is the right trade only when the stages' weights (here:
DFT operator matrices) are too big to replicate or the recording stream is
long enough to amortize the M+1-tick bubble; it is built for completeness of
the parallelism portfolio (SURVEY §2.3) and validated for correctness.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fmcw_radar_processing_tpu.config import RadarConfig
from fmcw_radar_processing_tpu.dsp.detection import DetectionResult, search_peaks
from fmcw_radar_processing_tpu.dsp.fast_time import FastTimeOperator, range_profile
from fmcw_radar_processing_tpu.dsp.slow_time import (
    DopplerPeaks,
    SlowTimeOperator,
    doppler_at_bins,
    doppler_peaks_at,
    measurements,
)
from fmcw_radar_processing_tpu.parallel.mesh import DATA_AXIS
from fmcw_radar_processing_tpu.pipeline.frame_chain import FrameChainOutputs

STAGE_AXIS = "stage"
NUM_STAGES = 2


def make_pp_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """(data, stage) mesh with a 2-device stage axis."""
    import numpy as np

    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % NUM_STAGES:
        raise ValueError(f"need a multiple of {NUM_STAGES} devices, have {n}")
    arr = np.asarray(devices).reshape(n // NUM_STAGES, NUM_STAGES)
    return Mesh(arr, (DATA_AXIS, STAGE_AXIS))


def make_pp_frame_chain(cfg: RadarConfig, mesh: Mesh, num_microbatches: int = 4):
    """Jitted pipeline-parallel chain over a mesh with a ``stage`` axis.

    Returns fn(raw [F, PN, NTS, 2], calib [NTS, 2]) -> FrameChainOutputs,
    numerically identical to `make_frame_chain(cfg)` (tests/test_pp_chain.py).
    F must divide by data_axis_size × num_microbatches.
    """
    if STAGE_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh needs a {STAGE_AXIS!r} axis: {mesh.axis_names}")
    if mesh.shape[STAGE_AXIS] != NUM_STAGES:
        raise ValueError(
            f"stage axis must have {NUM_STAGES} devices, "
            f"got {mesh.shape[STAGE_AXIS]}"
        )
    ft = FastTimeOperator.create(cfg)
    st = SlowTimeOperator.create(cfg)
    pn, k = cfg.pn, cfg.range_fft_size
    t_cap = cfg.algorithm.max_num_targets
    m = num_microbatches

    def slow_stage(rf):
        """Stage 1: everything downstream of the range FFT."""
        profile = range_profile(rf)  # [mb, K]
        det = search_peaks(profile, cfg)  # [mb, T]
        rd_rows = doppler_at_bins(st, rf, det.idx)  # [mb, T, D, 2]
        dop = doppler_peaks_at(rd_rows, cfg)
        meas = measurements(det, dop, cfg)
        strongest = jnp.take_along_axis(
            rf, det.idx[:, 0][:, None, None, None], axis=-2
        )[..., 0, :]  # [mb, PN, 2]
        return (profile, det.idx, det.magnitude, det.valid,
                dop.doppler_idx, dop.speed,
                meas.strength, meas.range, meas.speed,
                strongest, det.valid[:, 0])

    def _zero_outputs(mb):
        f32, i32 = jnp.float32, jnp.int32
        return (jnp.zeros((mb, k), f32),          # waterfall
                jnp.zeros((mb, t_cap), i32),      # det idx
                jnp.zeros((mb, t_cap), f32),      # det magnitude
                jnp.zeros((mb, t_cap), bool),     # det valid
                jnp.zeros((mb, t_cap), i32),      # doppler idx
                jnp.zeros((mb, t_cap), f32),      # doppler speed
                jnp.zeros((t_cap, mb), f32),      # strength
                jnp.zeros((t_cap, mb), f32),      # range
                jnp.zeros((t_cap, mb), f32),      # speed
                jnp.zeros((mb, pn, 2), f32),      # strongest chirps
                jnp.zeros((mb,), bool))           # detected

    def device_fn(raw, calib):
        # raw: this data-shard's frames [F_local, PN, NTS, 2], replicated
        # over the stage axis (only stage 0 reads it).
        sidx = lax.axis_index(STAGE_AXIS)
        f_local = raw.shape[0]
        if f_local % m:
            raise ValueError(
                f"frames/data-shard ({f_local}) must divide by "
                f"num_microbatches ({m})"
            )
        mb = f_local // m
        raw_mb = raw.reshape(m, mb, *raw.shape[1:])
        zeros_out = _zero_outputs(mb)

        def tick(carry, t):
            buf, acc = carry  # buf: activations arriving from the left

            # Stage 0 transforms microbatch t while t < M.
            def do_fast(_):
                raw_i = lax.dynamic_index_in_dim(
                    raw_mb, jnp.clip(t, 0, m - 1), 0, keepdims=False
                )
                return ft(raw_i, calib)  # [mb, PN, K, 2]

            send = lax.cond(
                jnp.logical_and(sidx == 0, t < m),
                do_fast, lambda _: jnp.zeros((mb, pn, k, 2), jnp.float32),
                operand=None,
            )

            # Stage 1 consumes microbatch t−1 from the previous tick.
            out = lax.cond(
                jnp.logical_and(sidx == NUM_STAGES - 1, t >= 1),
                lambda b: slow_stage(b), lambda b: zeros_out, buf,
            )
            slot = jnp.clip(t - 1, 0, m - 1)  # t=0 writes zeros, overwritten
            acc = jax.tree_util.tree_map(
                lambda a, o: lax.dynamic_update_index_in_dim(a, o, slot, 0),
                acc, out,
            )

            # Rotate activations one stage rightward (uniform collective).
            buf_next = lax.ppermute(
                send, STAGE_AXIS,
                perm=[(i, i + 1) for i in range(NUM_STAGES - 1)],
            )
            return (buf_next, acc), None

        acc0 = jax.tree_util.tree_map(
            lambda z: jnp.zeros((m, *z.shape), z.dtype), zeros_out
        )
        buf0 = jnp.zeros((mb, pn, k, 2), jnp.float32)
        (_, acc), _ = lax.scan(tick, (buf0, acc0), jnp.arange(m + 1))

        # Results live on the last stage; replicate across the stage axis
        # (other stages accumulated zeros; NaN-filled slots stay NaN).
        acc = jax.tree_util.tree_map(
            lambda a: lax.psum(
                a if a.dtype != bool else a.astype(jnp.int32),
                STAGE_AXIS,
            ), acc
        )
        (waterfall, didx, dmag, dvalid, dop_idx, dop_speed,
         strength, rng_m, speed, strongest, detected) = acc

        def frames_first(a):  # [M, mb, ...] → [F_local, ...]
            return a.reshape(f_local, *a.shape[2:])

        def targets_first(a):  # [M, T, mb] → [T, F_local]
            return jnp.moveaxis(a, 1, 0).reshape(t_cap, f_local)

        return FrameChainOutputs(
            waterfall=frames_first(waterfall),
            detection=DetectionResult(
                idx=frames_first(didx),
                magnitude=frames_first(dmag),
                valid=frames_first(dvalid).astype(bool),
            ),
            doppler=DopplerPeaks(
                doppler_idx=frames_first(dop_idx),
                speed=frames_first(dop_speed),
            ),
            strength=targets_first(strength),
            range=targets_first(rng_m),
            speed=targets_first(speed),
            strongest_chirps=frames_first(strongest),
            detected=frames_first(detected).astype(bool),
            range_fft=None,
        )

    frame_spec = P(DATA_AXIS, None, None, None)
    out_specs = FrameChainOutputs(
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
    )
    mapped = jax.shard_map(
        device_fn, mesh=mesh,
        in_specs=(frame_spec, P()),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(
        mapped,
        in_shardings=(NamedSharding(mesh, frame_spec), NamedSharding(mesh, P())),
    )
