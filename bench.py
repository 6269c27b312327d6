"""Benchmark: IQ frames/sec on the full radar chain, on the GPU it runs on.

Default mode prints ONE JSON line {"metric", "value", "unit",
"vs_baseline"} — the headline batched-replay throughput vs the
reference-semantics serial NumPy oracle on CPU (the stand-in for the
reference's MATLAB loop; the reference publishes no throughput numbers,
BASELINE.md).

``--matrix`` runs the full benchmark matrix over BASELINE.json's five
configs plus a literal-fidelity STFT line, with an (impl × matmul-precision
× artifact-dtype) variant grid on the batched-replay config,
and per-row estimated FLOPs, TFLOP/s, MFU, an analytic bytes/frame model
with achieved GB/s against the card's HBM peak, and output SNR vs the
MATLAB-semantics f64 oracle. Every row is steady-state on-device timing
with returned artifacts barrier-materialized (see _make_full). Results go
to chiprun_out/bench_matrix.json and printed JSON lines. Every mode prints
the card's kind, assumed peaks and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


# Published dense peaks per card, keyed by jax device_kind (NVIDIA's H100
# SXM data sheet; rates assume the full 700 W power limit, so they are printed
# beside the card's actual limit). A device missing here is an error: its
# roofline shares would otherwise come out silently empty.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbps": 3350.0,
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
    },
}


def chip_peaks() -> dict:
    import jax

    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise RuntimeError(f"no peak table for device {kind!r}; add one to "
                           "bench.PEAKS with its source")
    return PEAKS[kind]


def chip_peak_flops() -> float:
    """bf16 tensor-core peak: MFU is reported against it for every row —
    f32 matmuls cannot exceed it, so the figure is conservative."""
    return chip_peaks()["bf16_flops"]


def chip_peak_hbm_gbps() -> float:
    return chip_peaks()["hbm_gbps"]


def print_card() -> None:
    """One line: device kind, assumed peaks, and the card's power limit."""
    import subprocess

    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device_kind": jax.devices()[0].device_kind,
                      "peaks": chip_peaks(), "nvidia_smi": smi}), flush=True)


# ---------------------------------------------------------------------------
# FLOPs model (per frame) — analytic, from the operator shapes.
# ---------------------------------------------------------------------------

def chain_flops_per_frame(cfg, stft_nfft: int, with_rescale: bool = True) -> float:
    """FLOPs of the production chain per frame (f32 ops counted as
    2·M·N·K per matmul; elementwise/reduction epilogues are negligible).
    The log-frequency rescale is a 3-op lerp per output element."""
    pn, nts, k = cfg.pn, cfg.nts, cfg.range_fft_size
    d = cfg.doppler_fft_size
    t = cfg.algorithm.max_num_targets
    nb = stft_nfft // 2 + 1
    wl = cfg.algorithm.stft_window_length
    fast_time = 2.0 * pn * (2 * nts) * (2 * k)  # packed DFT matmul
    rf_rows = 2.0 * pn * (2 * nts) * (2 * t)  # detected-bin recompute
    doppler = 2.0 * t * (2 * pn) * (2 * d)
    stft = pn * 2 * (2.0 * nb * wl)  # PN new columns/frame, re+im matmuls
    rescale = pn * 3.0 * cfg.algorithm.max_freq_bins if with_rescale else 0.0
    return fast_time + rf_rows + doppler + stft + rescale


def chain_bytes_per_frame(cfg, stft_nfft: int, with_rescale: bool = True,
                          intensity_bytes: int = 4) -> float:
    """Analytic HBM bytes/frame of the fused full chain (f32 = 4 B).

    Minimal-traffic model under XLA fusion: each matmul result is written
    once and read once by its (fused-elementwise) consumer; elementwise
    chains do not round-trip. Terms, per frame (PN slow-time samples):

      raw          read twice — profile matmul + rf_at_bins recompute
      waterfall    [K] write + fingerprint read
      frame matrix [W, PN] write + one read each by the re/im STFT matmuls
      s_re, s_im   [nb, PN] written by the two matmuls, read by the fused
                   PSD epilogue
      psd→dB       [nb, PN] one write (PSD/dB elementwise chain fuses),
                   one read each by the global-max pass and the rescale
      intensity    [1024, PN] written once (``intensity_bytes`` per
                   element — 4 f32, 2 bf16); its consumer is the host DMA,
                   not another compute pass

    Small terms (detection outputs, packed rows, argsort keys, the [F·PN]
    magnitude signal) are included where ≥ 64 B/frame, dropped otherwise.
    The model is deliberately *minimal*: achieved-GB/s computed against it
    is a lower bound on true traffic, so hbm_pct is conservative.
    """
    pn, nts, k = cfg.pn, cfg.nts, cfg.range_fft_size
    nb = stft_nfft // 2 + 1
    wl = cfg.algorithm.stft_window_length
    raw = 2 * (pn * 2 * nts * 4)
    waterfall = 2 * (k * 4)
    pack = 4 * (pn * 2 * 4)  # strongest rows w+r, packed gather w+r
    sig = 2 * (pn * 4)  # |slow-time| magnitude write + framing read
    frames_mat = 3 * (wl * pn * 4)
    s_parts = 4 * (nb * pn * 4)
    psd = 3 * (nb * pn * 4)
    rescale = (cfg.algorithm.max_freq_bins * pn * intensity_bytes
               if with_rescale else 0)
    return float(raw + waterfall + pack + sig + frames_mat + s_parts + psd
                 + rescale)


# ---------------------------------------------------------------------------
# Timed pipelines. All sync on a scalar fingerprint of the outputs, so bulk
# device-to-host bandwidth is not part of the device-time metric.
# ---------------------------------------------------------------------------

def _make_full(cfg, impl: str, nfft: int):
    import jax
    import jax.numpy as jnp

    from fmcw_radar_processing_tpu.dsp.stft import (
        StftOperator,
        log_frequency_rescale,
        psd_db,
    )
    from fmcw_radar_processing_tpu.pipeline.frame_chain import (
        make_frame_chain,
        pack_slow_time,
    )
    from fmcw_radar_processing_tpu.utils.cplx import pair_abs

    chain = make_frame_chain(cfg, impl=impl)
    op = StftOperator.create(
        window_length=cfg.algorithm.stft_window_length,
        beta=cfg.algorithm.stft_kaiser_beta,
        nfft=nfft,
        fs=1.0 / cfg.derived.prt,
        hop=cfg.algorithm.stft_hop or 1,
        precision=cfg.algorithm.matmul_precision,
    )

    @jax.jit
    def full(raw_d, calib_d):
        out = chain(raw_d, calib_d)
        sig, count = pack_slow_time(out.strongest_chirps, out.detected, cfg.pn)
        int_dtype = {"bfloat16": jnp.bfloat16, "int8": jnp.int8}.get(
            cfg.algorithm.intensity_dtype, jnp.float32)
        res = op(pair_abs(sig), valid_len=count)
        db = psd_db(res)
        _, intensity = log_frequency_rescale(
            res.freqs, db, cfg.algorithm.max_freq_bins)
        if int_dtype == jnp.bfloat16:
            intensity = intensity.astype(jnp.bfloat16)
        elif int_dtype == jnp.int8:
            from fmcw_radar_processing_tpu.dsp.stft import quantize_db_int8

            intensity = quantize_db_int8(intensity)
        # The barrier forces the [1024, F·PN] intensity and the waterfall —
        # the artifacts production returns — to be fully written to device
        # memory before the fingerprint; without it XLA would fuse the sum
        # into the rescale epilogue and the largest tensor would never
        # exist. The probe then reads one contiguous block: production's
        # consumer of the artifact is the host transfer, not another
        # compute pass, so re-reading all of it would bill bench-only
        # traffic.
        intensity, waterfall = jax.lax.optimization_barrier(
            (intensity, out.waterfall)
        )
        probe = intensity[:, :128].astype(jnp.float32)
        return (
            jnp.sum(waterfall)
            + jnp.sum(jnp.where(jnp.isfinite(out.range), out.range, 0.0))
            + jnp.sum(jnp.where(jnp.isfinite(out.speed), out.speed, 0.0))
            + jnp.sum(jnp.where(jnp.isfinite(probe), probe, 0.0))
        )

    return full


def _scalar(out):
    """Pull the fingerprint scalar (last element if fn returns a tuple)."""
    return float(out[-1] if isinstance(out, tuple) else out)


def _intensity_bytes(cfg) -> int:
    """Per-element store size of the [1024, T] intensity artifact."""
    return {"bfloat16": 2, "int8": 1}.get(cfg.algorithm.intensity_dtype, 4)


def _latency_stats(scalar_fn, args, inners=(4096, 16384), runs: int = 5) -> dict:
    """Steady-state latency distribution for tiny programs.

    Sweeps inner ∈ {4k, 16k} on-device repetitions so the device signal
    (inner·latency) is ≫ dispatch jitter, takes the dispatch floor as
    min T(1) over ``runs`` repeats, and reports the median/p95 of the
    per-run estimates (T_run(inner) − floor) / (inner − 1)."""
    import numpy as np

    ests: list[float] = []
    per_inner: dict[int, float] = {}
    for inner in inners:
        r1 = _repeat_jit(scalar_fn, 1)
        rn = _repeat_jit(scalar_fn, inner)
        _scalar(r1(*args))
        _scalar(rn(*args))
        t1s, tns = [], []
        for _ in range(runs):
            t0 = time.perf_counter()
            _scalar(r1(*args))
            t1s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            _scalar(rn(*args))
            tns.append(time.perf_counter() - t0)
        floor = min(t1s)
        vals = [(tn - floor) / (inner - 1) for tn in tns if tn > floor]
        if vals:
            per_inner[inner] = float(np.median(vals))
            ests.extend(vals)
    if not ests:
        # Every repeated run landed at/below the dispatch floor (can happen
        # on CPU smoke runs where the whole program is sub-noise): fall
        # back to the inclusive rate rather than taking a median of an
        # empty array and recording NaN rows.
        inner = max(inners)
        rn = _repeat_jit(scalar_fn, inner)
        _scalar(rn(*args))
        t0 = time.perf_counter()
        _scalar(rn(*args))
        ests = [(time.perf_counter() - t0) / inner]
        per_inner[inner] = ests[0]
    arr = np.asarray(sorted(ests))
    return {
        "chip_latency_us": round(float(np.median(arr)) * 1e6, 3),
        "chip_latency_p95_us": round(float(np.percentile(arr, 95)) * 1e6, 3),
        "latency_samples": len(ests),
        "latency_per_inner_us": {
            str(k): round(v * 1e6, 3) for k, v in per_inner.items()
        },
    }


def _time_call(fn, args, iters: int = 5) -> float:
    """Min wall time of one fn(*args) call with a scalar D2H sync —
    latency including one host→device dispatch."""
    _scalar(fn(*args))  # warmup/compile
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        _scalar(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _repeat_jit(scalar_fn, n: int):
    """Wrap a scalar-returning traced fn so it runs n times inside ONE
    dispatched program. The optimization_barrier threads the accumulator
    through every iteration's *inputs*, so XLA can neither hoist the body
    out of the fori_loop nor CSE the iterations."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def run(*args):
        def body(_, acc):
            chained = jax.lax.optimization_barrier((acc,) + args)
            return chained[0] + scalar_fn(*chained[1:])
        return lax.fori_loop(0, n, body, jnp.float32(0.0))

    return run


def _time_steady(scalar_fn, args, inner: int = 8, iters: int = 3) -> float:
    """Steady-state per-iteration device time via on-device repetition:
    (time(2·inner runs) − time(inner runs)) / inner — two large endpoints,
    so the per-dispatch constant cancels."""
    ra = _repeat_jit(scalar_fn, inner)
    rb = _repeat_jit(scalar_fn, 2 * inner)
    _scalar(ra(*args))
    _scalar(rb(*args))
    ba = bb = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        _scalar(ra(*args))
        ba = min(ba, time.perf_counter() - t0)
        t0 = time.perf_counter()
        _scalar(rb(*args))
        bb = min(bb, time.perf_counter() - t0)
    dt = (bb - ba) / inner
    if dt <= 0:  # timing noise swamped the difference (tiny workloads on
        dt = bb / (2 * inner)  # CPU smoke): fall back to the inclusive rate
    return dt


def _bench_streaming_steady(sp, raw_c, calib_c, inner: int = 8,
                            iters: int = 3) -> float:
    """Steady-state seconds per streaming window.

    Chains ``inner`` windows inside ONE dispatched program, threading the
    carry/running-max state exactly as deployment does, and differences
    against a 1-window program to remove the dispatch constant. The
    optimization_barrier re-derives the (constant) raw input from the
    loop-carried accumulator each iteration so XLA cannot hoist the frame
    chain out of the loop."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    def make(n):
        @jax.jit
        def run(raw, calib, carry, clen, mp):
            def body(_, st):
                carry, clen, mp, acc = st
                acc, raw_b, calib_b = lax.optimization_barrier(
                    (acc, raw, calib)
                )
                outs = sp._step(raw_b, calib_b, carry, clen, mp)
                wf, psd = outs[0], outs[5]
                acc = acc + jnp.sum(psd[..., -1]) + jnp.sum(wf[..., -1, :])
                return (outs[9], outs[10], outs[11], acc)

            st0 = (carry, clen, mp, jnp.float32(0.0))
            return lax.fori_loop(0, n, body, st0)[3]

        return run

    # Difference between two large inner counts (inner vs 2·inner), both
    # min-of-iters, so the dispatch constant cancels.
    args = (raw_c, calib_c, sp._carry, sp._carry_len, sp._max_power)
    ra, rb = make(inner), make(2 * inner)
    float(ra(*args))
    float(rb(*args))
    ba = bb = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        float(ra(*args))
        ba = min(ba, time.perf_counter() - t0)
        t0 = time.perf_counter()
        float(rb(*args))
        bb = min(bb, time.perf_counter() - t0)
    dt = (bb - ba) / inner
    if dt <= 0:
        dt = bb / (2 * inner)
    return dt


def bench_device(cfg, raw, calib, iters: int = 3, impl: str = "auto",
                 nfft: int = 256, inner: int | None = None) -> float:
    import jax.numpy as jnp
    import numpy as np

    full = _make_full(cfg, impl, nfft)
    # Flat pair-rows across the jit boundary: a free host view.
    raw = np.asarray(raw).reshape(raw.shape[0], cfg.pn, -1)
    if inner is None:
        inner = 8 if raw.shape[0] >= 32768 else 32
    dt = _time_steady(full, (jnp.asarray(raw), jnp.asarray(calib)),
                      inner=inner, iters=iters)
    return raw.shape[0] / dt


def bench_cpu_oracle(cfg, raw_matlab, calib, nfft: int,
                     iters: int = 2) -> float:
    """Serial reference-semantics chain on CPU (frames/sec, best of
    ``iters`` — the shared bench host is noisy and a one-shot baseline
    made vs_baseline swing ~2× between runs)."""
    from tests.oracle import (
        log_rescale_oracle,
        process_recording_oracle,
        psd_db_oracle,
        spectrogram_oracle,
    )

    f = raw_matlab.shape[0]
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        res = process_recording_oracle(raw_matlab, calib, cfg)
        iq = abs(res.slow_time_signal)
        if len(iq) >= cfg.algorithm.stft_window_length:
            freqs, times, p = spectrogram_oracle(
                iq, 1.0 / cfg.derived.prt, nfft=nfft
            )
            db = psd_db_oracle(p)
            log_rescale_oracle(freqs, db)
        best = min(best, time.perf_counter() - t0)
    return f / best


# ---------------------------------------------------------------------------
# SNR vs the MATLAB-semantics oracle.
# ---------------------------------------------------------------------------

def _snr_db(got, want) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    ref = np.linalg.norm(want)
    if err == 0.0:
        return float("inf")
    return float(-20.0 * np.log10(err / max(ref, 1e-300)))


def snr_vs_oracle(cfg, rec, impl: str, nfft: int, f: int = 256) -> dict:
    """Chain+spectrogram SNR against tests/oracle.py on an f-frame subset."""
    import dataclasses

    import numpy as np

    from fmcw_radar_processing_tpu.pipeline.recording import RadarPipeline
    from tests.oracle import (
        log_rescale_oracle,
        process_recording_oracle,
        psd_db_oracle,
        spectrogram_oracle,
    )

    raw = rec.rx1_pair()[:f]
    calib = rec.calib_pair(0, cfg.nts)
    cfg_nfft = dataclasses.replace(
        cfg, algorithm=dataclasses.replace(cfg.algorithm, stft_nfft=nfft)
    )
    pipe = RadarPipeline(cfg_nfft, impl=impl)
    out = pipe.process_recording(raw, calib)

    raw_matlab = np.swapaxes(rec.rx1()[:f], -1, -2)
    res = process_recording_oracle(raw_matlab, rec.calib_vector(0, cfg.nts), cfg)
    iq = np.abs(res.slow_time_signal)
    freqs, _, p = spectrogram_oracle(iq, 1.0 / cfg.derived.prt, nfft=nfft)
    db = psd_db_oracle(p)
    _, want_intensity = log_rescale_oracle(freqs, db)

    t = min(out.spectrogram_intensity.shape[1], want_intensity.shape[1])
    floor = -1000.0  # dsp/stft.DB_FLOOR stands in for the oracle's -inf
    got_i = np.asarray(out.spectrogram_intensity, np.float64)[:, :t]
    want_i = np.asarray(want_intensity, np.float64)[:, :t]
    # Display-band error: max |err| over bins the reference actually
    # RENDERS — oracle dB within the PNG's clim [−40, 0]
    # (radar_processing.m:340). This is the promotion criterion for lossy
    # artifact dtypes: ≤ 0.15 dB here is invisible at the display clim.
    band = want_i >= -40.0
    display_err = (float(np.abs(got_i - want_i)[band].max())
                   if band.any() else 0.0)
    return {
        "waterfall_snr_db": round(
            _snr_db(out.waterfall, res.waterfall), 1
        ),
        "spectrogram_snr_db": round(
            _snr_db(
                np.maximum(got_i, floor), np.maximum(want_i, floor)
            ),
            1,
        ),
        "display_band_err_db": round(display_err, 4),
        "range_exact": bool(
            np.array_equal(
                np.nan_to_num(out.target_range), np.nan_to_num(res.range)
            )
        ),
    }


# ---------------------------------------------------------------------------
# Matrix
# ---------------------------------------------------------------------------

def run_matrix(quick: bool = False) -> list[dict]:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from fmcw_radar_processing_tpu.config import (
        AlgorithmConfig,
        RadarConfig,
        default_device_config,
    )
    from fmcw_radar_processing_tpu.config.radar import next_pow2
    from fmcw_radar_processing_tpu.io.synth import (
        SyntheticTarget,
        synthesize_recording,
    )

    nfft = 256
    # Base grid config pins intensity_dtype f32 so rows stay comparable
    # across rounds regardless of the production default; bf16 intensity
    # appears as its own explicit variant rows.
    cfg = RadarConfig.create(
        default_device_config(),
        AlgorithmConfig(stft_nfft=nfft, intensity_dtype="float32"),
    )
    peak = chip_peak_flops()
    backend = jax.devices()[0].device_kind
    targets = (
        SyntheticTarget(range_m=7.5, doppler_bin_offset=3,
                        md_phase_rad=1.0, md_rate_hz=40.0),
        SyntheticTarget(range_m=16.9, doppler_bin_offset=-2, amplitude=2.5),
    )
    f_big = 4096 if quick else 65536
    rec = synthesize_recording(cfg, f_big, targets, seed=0)
    raw_all = rec.rx1_pair()
    calib = rec.calib_pair(0, cfg.nts)
    rows: list[dict] = []
    fpf = chain_flops_per_frame(cfg, nfft)
    bpf = chain_bytes_per_frame(cfg, nfft)
    hbm_peak = chip_peak_hbm_gbps()

    def add(config, impl, fps, flops_per_frame, extra=None,
            bytes_per_frame=None):
        tf = fps * flops_per_frame
        row = {
            "config": config,
            "impl": impl,
            "frames_per_s": round(fps, 1),
            "est_mflop_per_frame": round(flops_per_frame / 1e6, 3),
            "tflops": round(tf / 1e12, 3),
            "mfu_pct": round(100 * tf / peak, 3) if peak else None,
        }
        if bytes_per_frame is not None:
            gbps = fps * bytes_per_frame / 1e9
            row["est_kb_per_frame"] = round(bytes_per_frame / 1024, 1)
            row["achieved_gbps"] = round(gbps, 1)
            row["hbm_pct"] = (round(100 * gbps / hbm_peak, 1)
                              if hbm_peak else None)
            if hbm_peak and gbps > hbm_peak:
                row["bandwidth_note"] = (
                    "implied GB/s above the HBM roof — physically "
                    "impossible; estimator overshoot at this program "
                    "size (see the ROOFLINE entry for the device-trace "
                    "rate)")
        row.update(extra or {})
        rows.append(row)
        print(json.dumps(row), flush=True)

    def robust(label, fn):
        """Run one matrix section; record a failure and move on."""
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — the row records it
            err = repr(e)[:200]
            print(json.dumps({"config": label, "error": err}), flush=True)
            rows.append({"config": label, "error": err})
            return None

    # -- BASELINE config 1: single synthetic IQ frame, fast-time + magnitude
    # Two numbers: device latency (steady-state, on-device repeat) and e2e
    # latency including one host↔device dispatch.
    from fmcw_radar_processing_tpu.dsp.fast_time import PackedFastTime

    pft = PackedFastTime.create(cfg)

    @jax.jit
    def single_ft(raw_d, calib_d):
        return jnp.sum(pft.profile(raw_d, calib_d))

    one = jnp.asarray(raw_all[:1])

    def config1():
        dt_e2e = _time_call(single_ft, (one, jnp.asarray(calib)))
        stats = _latency_stats(single_ft, (one, jnp.asarray(calib)))
        dt = stats["chip_latency_us"] * 1e-6
        stats["e2e_latency_us"] = round(dt_e2e * 1e6, 1)
        add("1_single_frame_fast_time", "fused", 1.0 / dt,
            2.0 * cfg.pn * 2 * cfg.nts * 2 * cfg.range_fft_size, stats)

    robust("1_single_frame_fast_time", config1)

    # -- BASELINE config 2: full single-frame chain -> range-speed
    from fmcw_radar_processing_tpu.pipeline.frame_chain import make_frame_chain

    chain1 = make_frame_chain(cfg)

    @jax.jit
    def single_full(raw_d, calib_d):
        out = chain1(raw_d, calib_d)
        return (jnp.sum(out.waterfall)
                + jnp.sum(jnp.nan_to_num(out.range))
                + jnp.sum(jnp.nan_to_num(out.speed)))

    def config2():
        dt_e2e = _time_call(single_full, (one, jnp.asarray(calib)))
        stats = _latency_stats(single_full, (one, jnp.asarray(calib)),
                               inners=(1024, 4096))
        dt = stats["chip_latency_us"] * 1e-6
        stats["e2e_latency_us"] = round(dt_e2e * 1e6, 1)
        add("2_single_frame_full_chain", "fused", 1.0 / dt,
            chain_flops_per_frame(cfg, nfft, with_rescale=False), stats)

    robust("2_single_frame_full_chain", config2)

    # -- BASELINE config 3: multi-frame STFT spectrogram, median of 3.
    f_mid = min(4096, f_big)

    def config3():
        import statistics

        fps3 = statistics.median(
            bench_device(cfg, raw_all[:f_mid], calib, nfft=nfft)
            for _ in range(3))
        add("3_multi_frame_stft", "fused", fps3, fpf,
            {"frames": f_mid, "trials": 3}, bytes_per_frame=bpf)

    robust("3_multi_frame_stft", config3)

    # -- BASELINE config 4: batched recording replay x (impl, precision) +
    # SNR: the fidelity/speed frontier of the chain's precision knobs.
    variants = (
        {"impl": "xla"},
        {"impl": "fused"},
        {"impl": "fused", "matmul_precision": "high"},
        {"impl": "fused", "matmul_precision": "default"},
        {"impl": "fused", "intensity_dtype": "bfloat16"},
        {"impl": "fused", "intensity_dtype": "int8"},
        {"impl": "fused_bf16"},
        {"impl": "fused_bf16", "matmul_precision": "default"},
    )
    for v in variants:
        v = dict(v)
        impl = v.pop("impl")
        cfg_v = dataclasses.replace(
            cfg, algorithm=dataclasses.replace(cfg.algorithm, **v)
        )
        fps = robust(f"4_batched_replay/{impl}", lambda: bench_device(
            cfg_v, raw_all, calib, impl=impl, nfft=nfft))
        if fps is None:
            continue
        extra = {"frames": f_big,
                 "precision": cfg_v.algorithm.matmul_precision}
        extra.update(v)
        try:
            extra.update(snr_vs_oracle(cfg_v, rec, impl, nfft))
        except Exception as e:  # oracle comparison must never kill the bench
            extra["snr_error"] = repr(e)
        add("4_batched_replay", impl, fps,
            chain_flops_per_frame(cfg_v, nfft), extra,
            bytes_per_frame=chain_bytes_per_frame(
                cfg_v, nfft, intensity_bytes=_intensity_bytes(cfg_v)))

    # -- BASELINE config 5: streaming 8-channel, steady-state: windows
    # chained on-device through the carry (the deployed shape — a resident
    # stream processor fed from device buffers, no per-window dispatch).
    from fmcw_radar_processing_tpu.pipeline.streaming import StreamingProcessor

    c, wf = 8, 256
    sp = StreamingProcessor(cfg, channels=c, window_frames=wf, nfft=nfft)
    raw_c = jax.device_put(
        np.broadcast_to(raw_all[:wf], (c, wf, cfg.pn, cfg.nts, 2))
        .reshape(c, wf, cfg.pn, -1).copy()  # flat pair-rows
    )
    calib_c = jax.device_put(np.broadcast_to(calib, (c, cfg.nts, 2)).copy())

    def config5():
        import statistics

        dt_win = statistics.median(
            _bench_streaming_steady(sp, raw_c, calib_c) for _ in range(3)
        )
        add("5_streaming_8ch", "fused", c * wf / dt_win, fpf,
            {"channels": c, "window_frames": wf, "trials": 3,
             "window_latency_us": round(dt_win * 1e6, 1)},
            bytes_per_frame=chain_bytes_per_frame(cfg, nfft,
                                                  with_rescale=False))

    robust("5_streaming_8ch", config5)

    # -- Fidelity mode: literal reference STFT (hop 1, nfft = 2^nextpow2(L))
    f_fid = 1024 if not quick else 256
    l_fid = f_fid * cfg.pn
    nfft_fid = next_pow2(l_fid)
    cfg_fid = RadarConfig.create(default_device_config(), AlgorithmConfig())

    def config6():
        fps_fid = bench_device(cfg_fid, raw_all[:f_fid], calib, nfft=nfft_fid)
        fps_prod = bench_device(cfg, raw_all[:f_fid], calib, nfft=nfft)
        add("6_fidelity_stft_nextpow2", "fused", fps_fid,
            chain_flops_per_frame(cfg_fid, nfft_fid),
            {"frames": f_fid, "nfft": nfft_fid,
             "fidelity_cost_x": round(fps_prod / fps_fid, 2)},
            bytes_per_frame=chain_bytes_per_frame(cfg_fid, nfft_fid))

    robust("6_fidelity_stft_nextpow2", config6)

    # -- Activity ('yes') batch mode: one of the two
    # production entry modes of the reference (radar_processing.m:440-607).
    # End-to-end HOST wall time of process_activity — the chain runs once
    # over the whole recording, then per-batch packing + STFT + payload
    # build for the first max_plots(4) qualifying batches (the reference's
    # early-stop, :597-599), including the per-batch D2H syncs and JSON
    # assembly a deployment pays. Median of 3 runs.
    def config7():
        import statistics

        from fmcw_radar_processing_tpu.pipeline.recording import RadarPipeline

        cfg_a = RadarConfig.create(default_device_config(),
                                   AlgorithmConfig.production())
        pipe = RadarPipeline(cfg_a)
        # Input pre-staged on device, like every other matrix row: what
        # this row measures is the activity mode's own cost: one chain
        # dispatch + per-batch pack/sync/STFT/D2H/payload for the first
        # max_plots qualifying batches.
        raw_dev = jax.device_put(
            np.asarray(raw_all).reshape(f_big, cfg.pn, -1))
        calib_dev = jax.device_put(np.asarray(calib))
        outs = pipe.process_activity(raw_dev, calib_dev)  # warm
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            pipe.process_activity(raw_dev, calib_dev)
            ts.append(time.perf_counter() - t0)
        dt = statistics.median(ts)
        add("7_activity_batch_mode", "production", f_big / dt,
            chain_flops_per_frame(cfg_a, nfft, with_rescale=False),
            {"frames": f_big, "batch_size": cfg_a.algorithm.batch_size,
             "max_plots": cfg_a.algorithm.max_plots,
             "batches_emitted": len(outs), "trials": 3,
             "wall_s_median": round(dt, 3),
             "wall_s_spread": [round(min(ts), 3), round(max(ts), 3)],
             "note": "host wall time end-to-end (device-resident input) "
                     "incl. per-batch D2H syncs + payload JSON assembly "
                     "— the 'yes' mode is host-orchestrated"})

    robust("7_activity_batch_mode", config7)

    meta = {
        "device_kind": backend,
        "peak_flops_assumed": peak,
        "peak_hbm_gbps_assumed": hbm_peak,
        "methodology": "steady-state on-device repetition for every row "
                       "(configs 1/2 also record e2e latency incl. one "
                       "dispatch); artifacts (intensity, "
                       "waterfall) are barrier-materialized so the timed "
                       "program writes what production returns; bytes "
                       "model documented at chain_bytes_per_frame",
        "note": "MFU against bf16 peak for all rows (f32 rows cannot exceed "
                "it; conservative and cross-dtype comparable)",
    }
    return [{"meta": meta}] + rows


def _xla_cost(compiled) -> tuple[float, float]:
    """(bytes accessed, flops) from XLA's compiler cost analysis."""
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    return (float(ca.get("bytes accessed", 0.0)),
            float(ca.get("flops", 0.0)))


def _trace_top_fusions(rep, args, dispatches: int, n_iter: int,
                       run=None) -> tuple[list, float]:
    """jax.profiler device trace of ``rep(*args)`` × dispatches →
    (top-fusion list with per-iteration µs + HLO identification,
    device µs/iteration). ``run`` overrides how one dispatch is driven."""
    import collections
    import gzip
    import os
    import re
    import tempfile

    import jax

    drive = run or (lambda: _scalar(rep(*args)))
    drive()  # compile + warm OUTSIDE the trace window
    tdir = tempfile.mkdtemp(prefix="fmcw_roofline_trace_")
    jax.profiler.start_trace(tdir)
    for _ in range(dispatches):
        drive()
    jax.profiler.stop_trace()

    trace_path = None
    for root, _, files in os.walk(tdir):
        for fn in files:
            if fn.endswith("trace.json.gz"):
                trace_path = os.path.join(root, fn)
    ops = collections.Counter()
    device_total_us = 0.0
    if trace_path:
        data = json.loads(gzip.open(trace_path).read())
        events = data.get("traceEvents", [])
        pids = {e["pid"]: e["args"]["name"] for e in events
                if e.get("ph") == "M" and e.get("name") == "process_name"}
        tids = {(e["pid"], e["tid"]): e["args"].get("name") for e in events
                if e.get("ph") == "M" and e.get("name") == "thread_name"}
        for e in events:
            if e.get("ph") != "X" or "/device:GPU" not in str(
                    pids.get(e["pid"], "")):
                continue
            lane = tids.get((e["pid"], e["tid"]), "")
            if lane == "XLA Ops":
                ops[e["name"]] += e.get("dur", 0.0)
            elif lane == "XLA Modules":
                device_total_us += e.get("dur", 0.0)

    # Attach HLO definition snippets so "fusion.N" is identifiable.
    hlo_lines = {}
    if rep is not None:
        hlo = rep.lower(*args).compile().as_text()
        for line in hlo.splitlines():
            s = line.strip()
            if s.startswith("%") and " = " in s:
                hlo_lines[s[1:].split(" ", 1)[0]] = s
            elif s.startswith("ROOT ") and " = " in s:
                hlo_lines[s[5:].split(" ", 1)[0]] = s
    top = []
    # Share against the MODULE device time (containers like the repeat
    # loop's `while` wrap their children in the ops lane and would
    # double-count against an ops-lane sum).
    total_us = device_total_us or sum(ops.values()) or 1.0
    for name, us in ops.most_common(14):
        line = hlo_lines.get(name, "")
        m = re.search(r'op_name="([^"]*)"', line)
        shape = line.split(" = ", 1)[1].split(" ", 1)[0] if " = " in line else ""
        top.append({
            "op": name,
            "us_per_iteration": round(us / n_iter, 2),
            "share_pct": round(100 * us / total_us, 1),
            "shape": shape[:100],
            "op_name": (m.group(1) if m else "")[:160],
            "is_container": name.startswith("while"),
        })
    return top, (device_total_us / n_iter if device_total_us else 0.0)


def _roofline_entry(cfg, full, args, frames: int, nfft: int,
                    label: str) -> dict:
    """One measured roofline entry for a full-chain program."""
    import numpy as np  # noqa: F401

    xla_bytes, xla_flops = _xla_cost(full.lower(*args).compile())
    dt = _time_steady(full, args)
    fps = frames / dt
    inner, dispatches = 8, 3
    rep = _repeat_jit(full, inner)
    top, dev_us = _trace_top_fusions(rep, args, dispatches,
                                     inner * dispatches)
    model_bpf = chain_bytes_per_frame(
        cfg, nfft, intensity_bytes=_intensity_bytes(cfg))
    xla_bpf = xla_bytes / frames
    hbm_peak = chip_peak_hbm_gbps()
    peak = chip_peak_flops()
    # The profiler's module device time bounds the rate for small
    # programs, where the wall estimator overshoots. Only substitute
    # DOWNWARD (fps_dev < fps): a trace that dropped module events would
    # inflate fps_dev.
    fps_dev = frames / (dev_us * 1e-6) if dev_us else None
    entry_fps = fps_dev if (fps_dev and fps_dev < fps
                            and (fps - fps_dev) / fps_dev > 0.1) else fps
    out_extra = {}
    if fps_dev and entry_fps is fps_dev:
        out_extra["fps_note"] = (
            "frames_per_s taken from the profiler's module device time "
            "(a lower, conservative bound); the wall difference estimator "
            f"read {round(fps, 1)} — its dispatch-constant jitter "
            "dominates at this program size")
    if hbm_peak and entry_fps * xla_bpf / 1e9 > hbm_peak:
        out_extra["bandwidth_note"] = (
            "implied GB/s from the XLA cost-analysis bytes exceeds the "
            "HBM roof — physically impossible as HBM traffic, so the "
            "cost-analysis byte count overcounts cache-served re-reads "
            "(multi-consumer operands) at this program size; "
            "measured_gbps_model (the "
            "minimal-traffic lower-bound model) is the defensible HBM "
            "figure")
    fps = entry_fps
    return {
        "config": label,
        "frames": frames,
        "frames_per_s": round(fps, 1),
        **({"frames_per_s_wall_estimator": round(frames / dt, 1)}
           if fps_dev and fps is fps_dev else {}),
        **out_extra,
        "model_bytes_per_frame": round(model_bpf, 1),
        "xla_bytes_per_frame": round(xla_bpf, 1),
        "xla_vs_model_ratio": round(xla_bpf / model_bpf, 3),
        "xla_flops_per_frame": round(xla_flops / frames, 1),
        "measured_gbps_xla": round(fps * xla_bpf / 1e9, 1),
        "measured_gbps_model": round(fps * model_bpf / 1e9, 1),
        "hbm_peak_gbps": hbm_peak,
        "hbm_pct_xla": (round(100 * fps * xla_bpf / 1e9 / hbm_peak, 1)
                        if hbm_peak else None),
        "mfu_pct_xla": (round(100 * fps * xla_flops / frames / peak, 2)
                        if peak else None),
        "device_us_per_iteration": round(dev_us, 1) if dev_us else None,
        "wall_us_per_iteration": round(dt * 1e6, 1),
        "top_fusions": top,
    }


def run_roofline(quick: bool = False) -> dict:
    """MEASURED roofline of BASELINE configs 3, 4 and 5.

    Complements the analytic ``chain_bytes_per_frame`` lower-bound model
    with two measurements of the exact production programs:

      * XLA's own compiler cost analysis (``Compiled.cost_analysis()``) —
        the per-op operand+output bytes the compiled HLO actually touches,
        summed over the module. This is the compiler's HBM-traffic
        accounting of the real fusion structure, not a hand model.
      * a ``jax.profiler`` device trace of the repeated program — the
        per-fusion device-time breakdown ("XLA Ops" lane), i.e. where the
        chip time measurably goes, with each hot fusion's HLO definition
        attached for identification.

    Writes chiprun_out/roofline.json and returns the artifact dict.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fmcw_radar_processing_tpu.config import (
        AlgorithmConfig,
        RadarConfig,
        default_device_config,
    )
    from fmcw_radar_processing_tpu.io.synth import (
        SyntheticTarget,
        synthesize_recording,
    )

    nfft = 256
    cfg = RadarConfig.create(default_device_config(),
                             AlgorithmConfig.production())
    f_big = 4096 if quick else 65536
    rec = synthesize_recording(
        cfg, f_big,
        (SyntheticTarget(range_m=7.5, doppler_bin_offset=3,
                         md_phase_rad=1.0, md_rate_hz=40.0),
         SyntheticTarget(range_m=16.9, doppler_bin_offset=-2,
                         amplitude=2.5)),
        seed=0,
    )
    raw = np.asarray(rec.rx1_pair()).reshape(f_big, cfg.pn, -1)
    calib = rec.calib_pair(0, cfg.nts)
    full = _make_full(cfg, "auto", nfft)

    entries = {}
    # --- config 4: production batched replay ---
    entries["4_batched_replay"] = _roofline_entry(
        cfg, full, (jnp.asarray(raw), jnp.asarray(calib)), f_big, nfft,
        "4_batched_replay production default")

    # --- config 3: multi-frame STFT at the BASELINE's 4096 frames ---
    f_mid = min(4096, f_big)
    entries["3_multi_frame_stft"] = _roofline_entry(
        cfg, full, (jnp.asarray(raw[:f_mid]), jnp.asarray(calib)), f_mid,
        nfft, "3_multi_frame_stft production profile")

    # --- config 5: streaming 8-channel steady state ---
    from fmcw_radar_processing_tpu.pipeline.streaming import (
        StreamingProcessor,
    )

    c, wf = 8, 256
    sp = StreamingProcessor(cfg, channels=c, window_frames=wf, nfft=nfft)
    raw_c = jax.device_put(
        np.broadcast_to(raw[:wf].reshape(wf, cfg.pn, -1),
                        (c, wf, cfg.pn, 2 * cfg.nts)).copy())
    calib_c = jax.device_put(np.broadcast_to(calib, (c, cfg.nts, 2)).copy())
    step = jax.jit(sp._step)
    sargs = (raw_c, calib_c, sp._carry, sp._carry_len, sp._max_power)
    sbytes, sflops = _xla_cost(step.lower(*sargs).compile())
    import statistics

    stream_trials = 5
    dt_win = statistics.median(
        _bench_streaming_steady(sp, raw_c, calib_c)
        for _ in range(stream_trials)
    )
    frames_win = c * wf
    fps5 = frames_win / dt_win
    model_bpf5 = chain_bytes_per_frame(cfg, nfft, with_rescale=False)
    hbm_peak = chip_peak_hbm_gbps()
    peak = chip_peak_flops()
    extra5 = {}
    if hbm_peak and fps5 * sbytes / frames_win / 1e9 > hbm_peak:
        extra5["bandwidth_note"] = (
            "implied GB/s from the XLA cost-analysis bytes exceeds the "
            "HBM roof — the _step cost analysis overcounts cache-served "
            "re-reads and multi-consumer operands at this window size; "
            "measured_gbps_model (minimal-traffic lower bound) is the "
            "defensible HBM figure")
    entries["5_streaming_8ch"] = {
        **extra5,
        "config": "5_streaming_8ch steady state",
        "channels": c, "window_frames": wf,
        "frames_per_s": round(fps5, 1),
        "window_latency_us": round(dt_win * 1e6, 1),
        "model_bytes_per_frame": round(model_bpf5, 1),
        "xla_bytes_per_frame": round(sbytes / frames_win, 1),
        "xla_vs_model_ratio": round(sbytes / frames_win / model_bpf5, 3),
        "xla_flops_per_frame": round(sflops / frames_win, 1),
        "measured_gbps_xla": round(fps5 * sbytes / frames_win / 1e9, 1),
        "measured_gbps_model": round(fps5 * model_bpf5 / 1e9, 1),
        "hbm_peak_gbps": hbm_peak,
        "hbm_pct_xla": (round(100 * fps5 * sbytes / frames_win / 1e9
                              / hbm_peak, 1) if hbm_peak else None),
        "mfu_pct_xla": (round(100 * fps5 * sflops / frames_win / peak, 2)
                        if peak else None),
        "note": ("bytes/flops from the single-window _step program's XLA "
                 "cost analysis; throughput from the two-large-endpoint "
                 "carry-threaded difference estimator (median of "
                 f"{stream_trials})"),
    }

    artifact = {
        "device_kind": jax.devices()[0].device_kind,
        "configs": entries,
        "methodology": (
            "xla_bytes = Compiled.cost_analysis()['bytes accessed'] of the "
            "single-iteration program (compiler accounting of per-op "
            "operand+output traffic); top_fusions "
            "from a jax.profiler device trace of the 8x-repeated program "
            "over 3 dispatches (XLA Ops lane, per-fusion device "
            "microseconds — fully measured); throughput via the matrix's "
            "steady-state on-device repetition"
        ),
    }
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/roofline.json", "w") as f:
        json.dump(artifact, f, indent=2)
    print(json.dumps(artifact, indent=2))
    return artifact


def main_matrix(quick: bool) -> int:
    rows = run_matrix(quick=quick)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/bench_matrix.json", "w") as f:
        json.dump(rows, f, indent=2)
    print(f"wrote chiprun_out/bench_matrix.json ({len(rows) - 1} rows)")
    return 0


def main():
    import numpy as np

    from fmcw_radar_processing_tpu.config import (
        AlgorithmConfig,
        RadarConfig,
        default_device_config,
    )
    from fmcw_radar_processing_tpu.io.synth import (
        SyntheticTarget,
        synthesize_recording,
    )

    nfft = 256
    # The production profile (see AlgorithmConfig.production for the
    # criterion), chain impl 'auto'.
    alg = AlgorithmConfig.production()
    cfg = RadarConfig.create(default_device_config(), alg)

    # 65536 frames ≈ 2.7 h of radar time at 150 ms/frame — a production-size
    # recording, large enough that per-dispatch latency stops dominating.
    frames = 65536
    rec = synthesize_recording(
        cfg,
        frames,
        (
            SyntheticTarget(range_m=7.5, doppler_bin_offset=3,
                            md_phase_rad=1.0, md_rate_hz=40.0),
            SyntheticTarget(range_m=16.9, doppler_bin_offset=-2, amplitude=2.5),
        ),
        seed=0,
    )
    raw = rec.rx1_pair()  # [F, PN, NTS, 2]
    calib = rec.calib_pair(0, cfg.nts)

    fps_dev = bench_device(cfg, raw, calib, nfft=nfft)

    # CPU oracle on a subset, extrapolated linearly (the oracle is a serial
    # per-frame loop; its cost is linear in frames).
    f_cpu = 256
    raw_matlab = np.swapaxes(rec.rx1()[:f_cpu], -1, -2)  # (F, NTS, PN)
    fps_cpu = bench_cpu_oracle(cfg, raw_matlab, rec.calib_vector(0, cfg.nts), nfft)

    print(
        json.dumps(
            {
                "metric": "IQ frames/sec (range-FFT+Doppler+STFT chain)",
                "value": round(fps_dev, 1),
                "unit": "frames/s",
                "vs_baseline": round(fps_dev / fps_cpu, 2),
            }
        )
    )


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix", action="store_true",
                    help="run the full benchmark matrix -> "
                         "chiprun_out/bench_matrix.json")
    ap.add_argument("--roofline", action="store_true",
                    help="measured roofline of configs 3/4/5 (XLA bytes + "
                         "profiler trace) -> chiprun_out/roofline.json")
    ap.add_argument("--quick", action="store_true",
                    help="smaller sizes")
    args = ap.parse_args()
    from fmcw_radar_processing_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    print_card()
    if args.roofline:
        run_roofline(args.quick)
        sys.exit(0)
    sys.exit(main_matrix(args.quick) if args.matrix else main())
