"""Run the radar chain end to end on the GPU and check it against the oracle.

    python chip_smoke.py            # one card: every single-device phase
    python chip_smoke.py --chips 4  # four cards: only the multi-device paths

The script exits non-zero, printing no result, when JAX's first device is not
a GPU. Each phase prints one line: its wall time, the device time of its
jitted work (host clock around block_until_ready, compiled and warm), and
each comparison with tests/oracle.py (the f64 MATLAB-semantics reference)
beside its tolerance and the matmul precision it ran at. Any failed check
ends the run with a traceback and exit code 1. After the card's name and
power limit, the last line is the JSON result that names the device.

Phases on one card (production = AlgorithmConfig.production(), fidelity =
the bare AlgorithmConfig()):
  recording  RadarPipeline.process_recording, production, 65,536 frames
  serve_once CLI synth + serve-once --profile production, local storage,
             4,096 frames
  http       serve/http_service.py in-process, 3 POST /process, 4,096 frames
  fidelity   CLI synth + process, fidelity profile, 1,024 frames
  streaming  StreamingProcessor, 8 channels × 256-frame windows, 3 windows
With --chips 4: the dp chain on 65,536 frames, the tp and pp chains, the sp
recording export and channel-sharded streaming, each against the
single-device chain, with a check that the work is spread over every card.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

WATERFALL_SNR_DB = 100.0  # waterfall vs the f64 oracle
PRODUCTION_DISPLAY_DB = 0.15  # bf16 intensity, oracle bins ≥ −40 dB
FIDELITY_SNR_DB = 100.0  # f32 intensity: this SNR ...
FIDELITY_DISPLAY_DB = 0.01  # ... or this display-band error
DISPLAY_FLOOR_DB = -40.0  # the reference PNG's clim (radar_processing.m:340)
ORACLE_CHUNK = 4096  # frames per oracle call (bounds its f64 cube)
TARGET_SPECS = ("7.5:3", "16.9:-2:2.5")  # CLI --target range:doppler[:amp]


class SmokeFailure(AssertionError):
    """A comparison fell outside its tolerance."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def targets():
    from fmcw_radar_processing_tpu.io.synth import SyntheticTarget

    out = []
    for spec in TARGET_SPECS:
        parts = spec.split(":")
        out.append(SyntheticTarget(
            range_m=float(parts[0]), doppler_bin_offset=int(parts[1]),
            **({"amplitude": float(parts[2])} if len(parts) > 2 else {})))
    return tuple(out)


def production_cfg():
    from fmcw_radar_processing_tpu.config import (
        AlgorithmConfig,
        RadarConfig,
        default_device_config,
    )

    return RadarConfig.create(default_device_config(),
                              AlgorithmConfig.production())


def precision_note(cfg) -> str:
    """What the config's precision knobs run as on this backend."""
    from fmcw_radar_processing_tpu.utils.cplx import mxu_precision

    a = cfg.algorithm
    return (f"matmul {a.matmul_precision}={mxu_precision(a.matmul_precision)}"
            f", rescale gather+lerp f32, intensity {a.intensity_dtype}")


def snr_db(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    if err == 0.0:
        return float("inf")
    return float(-20.0 * np.log10(err / max(np.linalg.norm(want), 1e-300)))


def report(name: str, metrics: dict) -> dict:
    print(f"[{name}] " + json.dumps(metrics, default=str), flush=True)
    return metrics


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def device_seconds(fn) -> float:
    """Warm host-clock time of fn()'s device work, ended by
    block_until_ready (fn is called once first so compilation is out)."""
    import jax

    jax.block_until_ready(fn())
    _, dt = timed(lambda: jax.block_until_ready(fn()))
    return dt


# ---------------------------------------------------------------- oracle ----

def chain_oracle(rec, cfg, chunk: int = ORACLE_CHUNK) -> dict:
    """tests/oracle.py's per-frame chain over a whole recording, in chunks
    so its (K, PN, F) complex128 cube stays small."""
    from tests.oracle import process_recording_oracle

    frames = np.swapaxes(rec.rx1(), -1, -2)  # (F, NTS, PN), MATLAB layout
    calib = rec.calib_vector(0, cfg.nts)
    parts = [process_recording_oracle(frames[i:i + chunk], calib, cfg)
             for i in range(0, frames.shape[0], chunk)]
    return {
        "waterfall": np.concatenate([p.waterfall for p in parts], axis=1),
        "range": np.concatenate([p.range for p in parts], axis=1),
        "speed": np.concatenate([p.speed for p in parts], axis=1),
        "detected": np.concatenate([p.detected for p in parts]),
        "slow": np.concatenate([p.slow_time_signal for p in parts]),
    }


def intensity_oracle(slow: np.ndarray, cfg, nfft: int) -> np.ndarray:
    """Log-frequency dB intensity [1024, T] of a slow-time signal."""
    from tests.oracle import (
        log_rescale_oracle,
        psd_db_oracle,
        spectrogram_oracle,
    )

    freqs, _, p = spectrogram_oracle(
        np.abs(slow), 1.0 / cfg.derived.prt,
        window_length=cfg.algorithm.stft_window_length,
        beta=cfg.algorithm.stft_kaiser_beta, nfft=nfft)
    _, want = log_rescale_oracle(freqs, psd_db_oracle(p),
                                 cfg.algorithm.max_freq_bins)
    return want


def compare_chain(got: dict, want: dict, cfg, what: str) -> dict:
    """Waterfall SNR, exact detections/ranges, speeds, and the injected
    strongest target's range. got: waterfall (K, F), range/speed (T, F),
    detected (F,)."""
    snr = snr_db(got["waterfall"], want["waterfall"])
    check(snr >= WATERFALL_SNR_DB,
          f"{what}: waterfall SNR {snr:.1f} dB < {WATERFALL_SNR_DB}")
    check(np.array_equal(got["detected"], want["detected"]),
          f"{what}: detections differ from the oracle")
    check(np.array_equal(np.nan_to_num(got["range"], nan=-1.0),
                         np.nan_to_num(want["range"], nan=-1.0)),
          f"{what}: ranges differ from the oracle")
    np.testing.assert_allclose(
        np.nan_to_num(got["speed"]), np.nan_to_num(want["speed"]),
        rtol=1e-5, atol=1e-6, err_msg=f"{what}: speeds differ from the oracle")
    strongest = targets()[0]
    expect = strongest.range_bin(cfg) * cfg.derived.dist_per_bin
    rng = np.asarray(got["range"])[0]
    check(bool(np.all(rng[got["detected"]] == np.float32(expect))),
          f"{what}: detected range is not the injected {expect} m")
    return {"waterfall_snr_db": round(snr, 2),
            "waterfall_snr_min_db": WATERFALL_SNR_DB,
            "detections_exact": True, "ranges_exact": True,
            "frames_detected": int(np.sum(got["detected"])),
            "range_m": expect}


def compare_intensity(got, want, *, min_snr_db: float | None,
                      max_display_db: float, what: str) -> dict:
    t = min(got.shape[1], want.shape[1])
    check(got.shape[1] == want.shape[1],
          f"{what}: {got.shape[1]} STFT columns, oracle has {want.shape[1]}")
    got = np.asarray(got, np.float64)[:, :t]
    want = np.asarray(want, np.float64)[:, :t]
    band = want >= DISPLAY_FLOOR_DB
    err = float(np.abs(got - want)[band].max()) if band.any() else 0.0
    floor = -1000.0  # dsp/stft.DB_FLOOR stands in for the oracle's −inf
    snr = snr_db(np.maximum(got, floor), np.maximum(want, floor))
    ok = err <= max_display_db or (min_snr_db is not None
                                   and snr >= min_snr_db)
    check(ok, f"{what}: display-band error {err:.4f} dB > {max_display_db}"
          + (f" and SNR {snr:.1f} dB < {min_snr_db}" if min_snr_db else ""))
    return {"intensity_display_err_db": round(err, 5),
            "intensity_display_max_db": max_display_db,
            "intensity_snr_db": round(snr, 2),
            **({"intensity_snr_min_db": min_snr_db} if min_snr_db else {}),
            "columns": t}


# ---------------------------------------------------------------- phases ----

def phase_recording(frames: int = 65536) -> dict:
    """RadarPipeline.process_recording, production profile."""
    import jax

    from fmcw_radar_processing_tpu.io.synth import synthesize_recording
    from fmcw_radar_processing_tpu.pipeline.frame_chain import (
        pack_slow_time,
        resolve_impl,
    )
    from fmcw_radar_processing_tpu.pipeline.recording import RadarPipeline
    from fmcw_radar_processing_tpu.utils.cplx import pair_abs

    t_start = time.perf_counter()
    cfg = production_cfg()
    rec = synthesize_recording(cfg, frames, targets(), seed=0)
    raw = np.ascontiguousarray(rec.rx1_pair().reshape(frames, cfg.pn, -1))
    calib = rec.calib_pair(0, cfg.nts)
    pipe = RadarPipeline(cfg)
    out, first_s = timed(lambda: pipe.process_recording(raw, calib))
    out, warm_s = timed(lambda: pipe.process_recording(raw, calib))
    raw_dev, calib_dev = jax.device_put(raw), jax.device_put(calib)
    dev_s = device_seconds(lambda: pipe.run_chain(raw_dev, calib_dev))
    chained = pipe.run_chain(raw_dev, calib_dev)
    sig, count = pack_slow_time(chained.strongest_chirps, chained.detected,
                                cfg.pn)
    export, _ = pipe._stft_stage(cfg.algorithm.stft_nfft)
    export_s = device_seconds(lambda: export(pair_abs(sig), count))
    want, oracle_s = timed(lambda: chain_oracle(rec, cfg))
    m = compare_chain({"waterfall": out.waterfall, "range": out.target_range,
                       "speed": out.target_speed, "detected": out.detected},
                      want, cfg, "recording")
    inten = out.spectrogram_intensity
    check(inten.shape[0] == cfg.algorithm.max_freq_bins
          and np.isfinite(inten).all(), "recording: intensity not finite")
    check(float(inten.max()) <= 1e-3,
          "recording: intensity exceeds the 0 dB normalization")
    return report("recording", {
        "frames": frames, "impl": resolve_impl("auto"),
        "precision": precision_note(cfg), **m,
        "intensity_shape": list(inten.shape),
        "wall_s": round(time.perf_counter() - t_start, 3),
        "first_call_s": round(first_s, 3), "warm_call_s": round(warm_s, 3),
        "chain_device_s": round(dev_s, 5),
        "export_device_s": round(export_s, 5), "oracle_s": round(oracle_s, 2)})


def _synth_cli(base: str, frames: int, specs=TARGET_SPECS) -> None:
    from fmcw_radar_processing_tpu.serve import cli

    argv = ["synth", base, "--frames", str(frames), "--seed", "0"]
    for s in specs:
        argv += ["--target", s]
    check(cli.main(argv) == 0, "CLI synth failed")


def _png_size(path: str) -> tuple[int, int]:
    with open(path, "rb") as f:
        head = f.read(24)
    check(head[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def _check_artifacts(d: str, name: str, cfg) -> dict:
    expect = [f"{name}_range_fft_data.json", f"{name}_range_speed_data.json",
              f"{name}_fft_data.json", "spectrogram_data.json",
              "spectrogram.png"]
    missing = [e for e in expect if not os.path.exists(os.path.join(d, e))]
    check(not missing, f"missing artifacts in {d}: {missing}")
    with open(os.path.join(d, f"{name}_range_speed_data.json")) as f:
        rs = json.load(f)
    ranges = np.asarray([r for r in np.ravel(rs["range"]) if r is not None])
    want = targets()[0].range_bin(cfg) * cfg.derived.dist_per_bin
    check(ranges.size > 0 and np.all(ranges == want),
          f"range payload is not the injected {want} m")
    w, h = _png_size(os.path.join(d, "spectrogram.png"))
    check((w, h) == (1200, 800), f"spectrogram.png is {w}x{h}")
    return {"artifacts": len(expect), "payload_range_m": want,
            "spectrogram_json_mb": round(os.path.getsize(
                os.path.join(d, "spectrogram_data.json")) / 2**20, 1)}


def _recording_checks(basepath: str, cfg, *, min_snr_db, max_display_db,
                      what: str) -> dict:
    """The library run of the recording the CLI/service just processed,
    compared with the oracle: chain outputs and the exported intensity."""
    from fmcw_radar_processing_tpu.config import RadarConfig
    from fmcw_radar_processing_tpu.config.radar import next_pow2
    from fmcw_radar_processing_tpu.io.raw_format import read_recording
    from fmcw_radar_processing_tpu.pipeline.recording import RadarPipeline

    rec = read_recording(basepath)
    cfg = RadarConfig.create(rec.device, cfg.algorithm)
    out = RadarPipeline(cfg).process_recording(
        rec.rx1_pair(), rec.calib_pair(0, cfg.nts))
    want = chain_oracle(rec, cfg)
    m = compare_chain({"waterfall": out.waterfall, "range": out.target_range,
                       "speed": out.target_speed, "detected": out.detected},
                      want, cfg, what)
    nfft = cfg.algorithm.stft_nfft or next_pow2(len(want["slow"]))
    m["nfft"] = nfft
    m.update(compare_intensity(
        out.spectrogram_intensity, intensity_oracle(want["slow"], cfg, nfft),
        min_snr_db=min_snr_db, max_display_db=max_display_db, what=what))
    return m


def phase_serve_once(workdir: str, frames: int = 4096) -> dict:
    """CLI synth, then serve-once --profile production on local storage."""
    from fmcw_radar_processing_tpu.serve import cli

    t_start = time.perf_counter()
    blob = os.path.join(workdir, "blob")
    work = os.path.join(workdir, "serve_once")
    os.makedirs(blob)
    os.makedirs(work)
    _synth_cli(os.path.join(blob, "radar_data"), frames)
    rc, serve_s = timed(lambda: cli.main([
        "serve-once", "--fdata", "radar_data", "--workdir", work,
        "--storage", f"local:{blob}", "--profile", "production"]))
    check(rc == 0, f"serve-once exited {rc}")
    cfg = production_cfg()
    m = _check_artifacts(work, "radar_data", cfg)
    check(os.path.exists(os.path.join(blob, "spectrogram.png")),
          "serve-once did not upload spectrogram.png")
    m.update(_recording_checks(
        os.path.join(blob, "radar_data"), cfg, min_snr_db=None,
        max_display_db=PRODUCTION_DISPLAY_DB, what="serve_once"))
    return report("serve_once", {
        "frames": frames, "precision": precision_note(cfg), **m,
        "serve_once_s": round(serve_s, 3),
        "wall_s": round(time.perf_counter() - t_start, 3)})


def phase_http(workdir: str, frames: int = 4096, requests: int = 3) -> dict:
    """serve/http_service.py at the production profile, 3 POST /process."""
    import urllib.request

    from fmcw_radar_processing_tpu.serve.handler import HandlerConfig
    from fmcw_radar_processing_tpu.serve.http_service import RadarHttpService

    t_start = time.perf_counter()
    blob = os.path.join(workdir, "http_blob")
    work = os.path.join(workdir, "http_work")
    os.makedirs(blob)
    os.makedirs(work)
    _synth_cli(os.path.join(blob, "radar_data"), frames)
    hc = HandlerConfig(fdata="radar_data", workdir=work,
                       storage_spec=f"local:{blob}", profile="production",
                       pretty_json=False)
    latencies = []
    with RadarHttpService(hc, port=0) as srv:
        for _ in range(requests):
            req = urllib.request.Request(
                srv.url + "process",
                data=json.dumps({"processAnimalActivity": "no"}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                body = json.loads(r.read())
                status = r.status
            latencies.append(time.perf_counter() - t0)
            check(status == 200 and body["status"] == "success",
                  f"POST /process answered {status}: {body}")
    cfg = production_cfg()
    m = _check_artifacts(work, "radar_data", cfg)
    return report("http", {
        "frames": frames, "requests": requests,
        "precision": precision_note(cfg), **m,
        "latency_s": [round(x, 3) for x in latencies],
        "wall_s": round(time.perf_counter() - t_start, 3)})


def phase_fidelity(workdir: str, frames: int = 1024) -> dict:
    """CLI synth + process: the fidelity profile, nfft = 2^nextpow2(L)."""
    from fmcw_radar_processing_tpu.config import (
        RadarConfig,
        default_device_config,
    )
    from fmcw_radar_processing_tpu.serve import cli

    t_start = time.perf_counter()
    base = os.path.join(workdir, "fidelity", "rec")
    out_dir = os.path.join(workdir, "fidelity", "out")
    os.makedirs(out_dir)
    _synth_cli(base, frames, specs=TARGET_SPECS[:1])
    rc, process_s = timed(lambda: cli.main(
        ["process", base, "--output-dir", out_dir, "--compact-json"]))
    check(rc == 0, f"process exited {rc}")
    cfg = RadarConfig.create(default_device_config())
    m = _check_artifacts(out_dir, "rec", cfg)
    m.update(_recording_checks(
        base, cfg, min_snr_db=FIDELITY_SNR_DB,
        max_display_db=FIDELITY_DISPLAY_DB, what="fidelity"))
    return report("fidelity", {
        "frames": frames, "precision": precision_note(cfg), **m,
        "process_s": round(process_s, 3),
        "wall_s": round(time.perf_counter() - t_start, 3)})


def _streaming_inputs(cfg, channels: int, frames: int):
    from fmcw_radar_processing_tpu.io.synth import synthesize_recording

    recs = [synthesize_recording(cfg, frames, targets(), seed=c)
            for c in range(channels)]
    raw = np.stack([r.rx1_pair().reshape(frames, cfg.pn, -1) for r in recs])
    calib = np.stack([r.calib_pair(0, cfg.nts) for r in recs])
    return recs, raw, calib


def phase_streaming(channels: int = 8, window: int = 256,
                    windows: int = 3) -> dict:
    """StreamingProcessor: per-window chain outputs and the carried STFT
    columns of every channel against the oracle."""
    import jax

    from fmcw_radar_processing_tpu.pipeline.streaming import (
        StreamingProcessor,
    )
    from tests.oracle import spectrogram_oracle

    t_start = time.perf_counter()
    cfg = production_cfg()
    recs, raw, calib = _streaming_inputs(cfg, channels, window * windows)
    sp = StreamingProcessor(cfg, channels=channels, window_frames=window)
    psd_cols = [[] for _ in range(channels)]
    results = []
    for w in range(windows):
        res = sp.process_window(raw[:, w * window:(w + 1) * window], calib)
        results.append(jax.device_get(res))
    sp.reset()
    win0 = raw[:, :window]
    dev_s = device_seconds(lambda: sp.process_window(win0, calib).psd)
    min_snr, min_psd_snr = float("inf"), float("inf")
    for c in range(channels):
        want = chain_oracle(recs[c], cfg)
        for w, res in enumerate(results):
            sl = slice(w * window, (w + 1) * window)
            m = compare_chain(
                {"waterfall": res.waterfall[c].T, "range": res.range[c],
                 "speed": res.speed[c], "detected": res.detected[c]},
                {k: (v[..., sl] if k != "slow" else v)
                 for k, v in want.items()}, cfg, f"streaming ch{c} w{w}")
            min_snr = min(min_snr, m["waterfall_snr_db"])
            psd_cols[c].append(res.psd[c][:, :int(res.col_count[c])])
        got = np.concatenate(psd_cols[c], axis=1)
        _, _, p = spectrogram_oracle(np.abs(want["slow"]),
                                     1.0 / cfg.derived.prt, nfft=sp.nfft)
        check(got.shape == p.shape,
              f"streaming ch{c}: {got.shape} STFT columns, oracle {p.shape}")
        s = snr_db(got, p)
        check(s >= WATERFALL_SNR_DB,
              f"streaming ch{c}: PSD SNR {s:.1f} dB < {WATERFALL_SNR_DB}")
        min_psd_snr = min(min_psd_snr, s)
    return report("streaming", {
        "channels": channels, "window_frames": window, "windows": windows,
        "precision": precision_note(cfg),
        "min_waterfall_snr_db": round(min_snr, 2),
        "min_psd_snr_db": round(min_psd_snr, 2),
        "psd_snr_min_db": WATERFALL_SNR_DB, "detections_exact": True,
        "window_device_s": round(dev_s, 5),
        "wall_s": round(time.perf_counter() - t_start, 3)})


# ---------------------------------------------------------- multi-device ----

def _check_vs_single(got, want, what: str) -> None:
    """Sharded outputs must match the single-device chain: masks and
    ranges exactly, float maps to rtol 3e-4 (other reduction orders)."""
    np.testing.assert_array_equal(np.asarray(got.detected),
                                  np.asarray(want.detected),
                                  err_msg=f"{what}: detected mask")
    np.testing.assert_allclose(np.asarray(got.waterfall),
                               np.asarray(want.waterfall), rtol=3e-4,
                               atol=0.05, err_msg=f"{what}: waterfall")
    np.testing.assert_array_equal(np.nan_to_num(np.asarray(got.range)),
                                  np.nan_to_num(np.asarray(want.range)),
                                  err_msg=f"{what}: range")
    np.testing.assert_allclose(np.nan_to_num(np.asarray(got.speed)),
                               np.nan_to_num(np.asarray(want.speed)),
                               rtol=1e-4, atol=1e-6, err_msg=f"{what}: speed")


def _spread(arr, n: int, what: str) -> list[int]:
    """Device ids holding shards of arr: n devices, each holding a
    different slice (a replicated array would show one slice n times)."""
    shards = arr.addressable_shards
    ids = sorted({s.device.id for s in shards})
    slices = {str(s.index) for s in shards}
    check(len(ids) == n and len(slices) == n,
          f"{what}: {len(slices)} distinct slices on devices {ids}, "
          f"expected {n} on {n}")
    return ids


def phase_multi_device(n: int = 4, frames: int = 65536,
                       small_frames: int = 4096, channels: int = 8,
                       window: int = 256) -> dict:
    """dp/tp/pp chains, the sp recording export and channel-sharded
    streaming on an n-device mesh, each against the single-device path."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fmcw_radar_processing_tpu.config import (
        AlgorithmConfig,
        RadarConfig,
    )
    from fmcw_radar_processing_tpu.io.synth import synthesize_recording
    from fmcw_radar_processing_tpu.parallel.mesh import DATA_AXIS, make_mesh
    from fmcw_radar_processing_tpu.parallel.pp_chain import (
        make_pp_frame_chain,
        make_pp_mesh,
    )
    from fmcw_radar_processing_tpu.parallel.sharded_chain import (
        make_sharded_frame_chain,
    )
    from fmcw_radar_processing_tpu.parallel.sp_recording import (
        ShardedRecordingPipeline,
    )
    from fmcw_radar_processing_tpu.parallel.tp_chain import (
        make_tp_frame_chain,
    )
    from fmcw_radar_processing_tpu.pipeline.frame_chain import (
        make_frame_chain,
    )
    from fmcw_radar_processing_tpu.pipeline.recording import RadarPipeline
    from fmcw_radar_processing_tpu.pipeline.streaming import (
        StreamingProcessor,
    )

    t_start = time.perf_counter()
    devices = jax.devices()[:n]
    check(len(devices) == n, f"need {n} devices, have {len(jax.devices())}")
    mesh = make_mesh(data=n, model=1, devices=devices)
    cfg = production_cfg()
    rec = synthesize_recording(cfg, frames, targets(), seed=0)
    raw = rec.rx1_pair()  # [F, PN, NTS, 2], the sharded chains' layout
    calib = jnp.asarray(rec.calib_pair(0, cfg.nts))
    chain = make_frame_chain(cfg)
    raw_single = jax.device_put(raw, devices[0])
    single = chain(raw_single, calib)
    m: dict = {"devices": n, "precision": precision_note(cfg)}

    dp = make_sharded_frame_chain(cfg, mesh)
    raw_dp = jax.device_put(raw, NamedSharding(mesh, P(DATA_AXIS)))
    out = dp(raw_dp, calib)
    _check_vs_single(out, single, "dp chain")
    m["dp_devices"] = _spread(out.waterfall, n, "dp chain")
    m["dp_device_s"] = round(device_seconds(lambda: dp(raw_dp, calib)), 5)
    m["single_device_s"] = round(device_seconds(
        lambda: chain(raw_single, calib)), 5)
    m["peak_mb_per_device"] = [  # None where the backend keeps no stats
        round((d.memory_stats() or {}).get("peak_bytes_in_use", 0) / 2**20, 1)
        for d in devices]

    small = jnp.asarray(raw[:small_frames])
    single_small = chain(small, calib)
    tp_mesh = make_mesh(data=n // 2, model=2, devices=devices)
    tp = make_tp_frame_chain(cfg, tp_mesh)(small, calib)
    _check_vs_single(tp, single_small, "tp chain")
    m["tp_devices"] = sorted({s.device.id
                              for s in tp.waterfall.addressable_shards})
    pp = make_pp_frame_chain(cfg, make_pp_mesh(n), num_microbatches=2)(
        small, calib)
    _check_vs_single(pp, single_small, "pp chain")
    m["pp_checked"] = True

    cfg256 = RadarConfig.create(cfg.device, AlgorithmConfig(stft_nfft=256))
    raw_sp = rec.rx1_pair()[:small_frames]
    calib_sp = rec.calib_pair(0, cfg.nts)
    got = ShardedRecordingPipeline(cfg256, mesh).process(raw_sp, calib_sp)
    want = RadarPipeline(cfg256).process_recording(raw_sp, calib_sp)
    np.testing.assert_array_equal(got["detected"], want.detected)
    # Deep bins are limited by f32 cancellation at spectral nulls, which
    # the two programs' different summation orders move; the display band
    # is held tight, the rest to the display criterion.
    diff = np.abs(got["spectrogram_intensity"] - want.spectrogram_intensity)
    limits = ((DISPLAY_FLOOR_DB, 2e-3), (-120.0, PRODUCTION_DISPLAY_DB))
    errs = [float(diff[want.spectrogram_intensity >= floor].max())
            for floor, _ in limits]
    m["sp_max_err_db"] = {f"ge_{int(f)}": round(e, 5)
                          for (f, _), e in zip(limits, errs)}
    psd = want.spectrogram_psd_db
    m["sp_psd_db_max_err_ge_-40"] = round(float(np.abs(
        got["spectrogram_db"] - psd)[psd >= DISPLAY_FLOOR_DB].max()), 5)
    m["sp_columns"] = int(want.spectrogram_intensity.shape[1])
    for (floor, tol), err in zip(limits, errs):
        check(err <= tol, f"sp recording: intensity differs by {err:.4f} "
              f"dB over bins ≥ {floor} dB (limit {tol})")

    _, sraw, scalib = _streaming_inputs(cfg, channels, window)
    sharded = StreamingProcessor(cfg, channels=channels, window_frames=window,
                                 mesh=mesh).process_window(sraw, scalib)
    plain = StreamingProcessor(cfg, channels=channels,
                               window_frames=window).process_window(
                                   sraw, scalib)
    np.testing.assert_array_equal(np.asarray(sharded.detected),
                                  np.asarray(plain.detected))
    np.testing.assert_allclose(np.asarray(sharded.waterfall),
                               np.asarray(plain.waterfall), rtol=3e-4,
                               atol=0.05, err_msg="sharded streaming")
    s = snr_db(sharded.psd, plain.psd)
    check(s >= WATERFALL_SNR_DB,
          f"sharded streaming: PSD SNR {s:.1f} dB vs single-device")
    m["streaming_psd_snr_db"] = round(s, 2)
    m["streaming_devices"] = _spread(sharded.psd, n, "sharded streaming")
    m["wall_s"] = round(time.perf_counter() - t_start, 3)
    return report("multi_device", m)


# ------------------------------------------------------------------ main ----

def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4 runs only the multi-device paths, on 4 cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU found: JAX's first device is {devices[0].platform!r}",
              file=sys.stderr)
        return 2
    if len(devices) < args.chips:
        print(f"--chips {args.chips} needs {args.chips} GPUs, found "
              f"{len(devices)}", file=sys.stderr)
        return 2
    from fmcw_radar_processing_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    try:
        print(f"card: {gpu_line()}", flush=True)
        print(f"compile cache: {enable_compile_cache()}", flush=True)
        if args.chips == 4:
            phase_multi_device(4)
        else:
            phase_recording()
            with tempfile.TemporaryDirectory(prefix="fmcw_smoke_") as work:
                phase_serve_once(work)
                phase_http(work)
                phase_fidelity(work)
            phase_streaming()
    except Exception:  # noqa: BLE001 — report the failed phase, exit 1
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
