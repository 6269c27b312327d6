"""Long-signal recording export over a device mesh — the sp integration.

The reference's STFT is one serial ``spectrogram`` call over the whole
concatenated slow-time signal (radar_processing.m:270-299). Here the
ENTIRE long-signal export runs SPMD over the mesh (SURVEY §5.7/§5.8):

  1. the dp-sharded frame chain produces per-frame outputs sharded over
     the ``data`` axis (parallel/sharded_chain.py — zero communication);
  2. the global fixed-capacity packing (pipeline/frame_chain.py
     ``pack_slow_time``) runs on the sharded arrays under jit — XLA
     inserts the sort/gather collectives from the sharding annotations;
  3. :class:`ShardedStft` computes each device's STFT columns with the
     W−1 = 19-sample ``ppermute`` halo and pmaxes the global dB max;
  4. the log-frequency rescale is a per-column interpolation, so it runs on
     the column-sharded dB map with the sharding preserved — the
     [1024, L] intensity (the chain's largest artifact) is produced fully
     distributed and never resident on one device;
  5. host 0 assembles the JSON payload (parallel/multihost.py).

On the cards of one host the collectives ride NVLink; in CI the same
program runs on the virtual CPU mesh (tests/test_sp_recording.py) and in
``__graft_entry__.dryrun_multichip``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fmcw_radar_processing_tpu.config import RadarConfig
from fmcw_radar_processing_tpu.dsp.stft import (
    StftOperator,
    log_bins_axis,
    log_frequency_rescale,
    stft_frame_count,
)
from fmcw_radar_processing_tpu.parallel.mesh import DATA_AXIS
from fmcw_radar_processing_tpu.parallel.multihost import (
    distribute_frames,
    gather_to_all,
)
from fmcw_radar_processing_tpu.parallel.sharded_chain import (
    make_sharded_frame_chain,
)
from fmcw_radar_processing_tpu.parallel.sharded_stft import ShardedStft
from fmcw_radar_processing_tpu.pipeline.frame_chain import pack_slow_time
from fmcw_radar_processing_tpu.pipeline.payloads import spectrogram_payload
from fmcw_radar_processing_tpu.utils.cplx import pair_abs, to_pair


class ShardedRecordingPipeline:
    """Mesh-wide recording → spectrogram-payload pipeline.

    The single-device equivalent is ``RadarPipeline.process_recording``
    (pipeline/recording.py); outputs match it numerically
    (tests/test_sp_recording.py) — the difference is that every stage is
    sharded, so recording length scales with the mesh instead of one
    card's memory and throughput.
    """

    def __init__(self, cfg: RadarConfig, mesh: Mesh,
                 filename: str = "radar_data"):
        if cfg.algorithm.stft_nfft is None:
            raise ValueError(
                "ShardedRecordingPipeline needs a fixed stft_nfft "
                "(fidelity-mode next-pow-2 bucketing is data-dependent)"
            )
        self.cfg = cfg
        self.mesh = mesh
        self.filename = filename
        self.chain = make_sharded_frame_chain(cfg, mesh)
        a = cfg.algorithm
        self.op = StftOperator.create(
            window_length=a.stft_window_length,
            beta=a.stft_kaiser_beta,
            nfft=a.stft_nfft,
            fs=1.0 / cfg.derived.prt,
            hop=a.stft_hop or 1,
            precision=a.matmul_precision,
        )
        self.stft = ShardedStft(op=self.op, mesh=mesh)
        sig_sharding = NamedSharding(mesh, P(DATA_AXIS))

        freqs = self.stft.freqs

        # Per-column interpolation, run on each device's own columns: the
        # [1024, L] intensity stays column-sharded, and each device computes
        # exactly what the single-device export does.
        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=P(None, DATA_AXIS),
                           out_specs=P(None, DATA_AXIS))
        def rescale(db_local):
            return log_frequency_rescale(freqs, db_local, a.max_freq_bins)[1]

        def export(sig_abs, count):
            sig_abs = jax.lax.with_sharding_constraint(sig_abs, sig_sharding)
            _, db, _ = self.stft(sig_abs, count)
            return db, rescale(db)

        self._export = jax.jit(export)

    def process(self, raw: np.ndarray, calib: np.ndarray) -> dict:
        """Run the full sharded export.

        raw: [F, PN, NTS, 2] float32 pairs (or complex [F, PN, NTS]) —
        this process's LOCAL frame shard when multi-process, the whole
        recording single-process. F·(process count) must divide by the
        data-axis size. Returns (on every process) a dict with the
        gathered waterfall/measurements and the spectrogram payload.
        """
        cfg = self.cfg
        if np.iscomplexobj(raw):
            raw = to_pair(np.asarray(raw))
        if np.iscomplexobj(calib) or calib.ndim == 1:
            calib = to_pair(np.asarray(calib))
        raw_g = distribute_frames(np.asarray(raw, np.float32), self.mesh)
        out = self.chain(raw_g, jnp.asarray(calib))
        sig, count_dev = pack_slow_time(
            out.strongest_chirps, out.detected, cfg.pn
        )
        count = int(count_dev)  # single host sync (as RadarPipeline)
        wl = self.op.window_length
        if count < wl:
            db = intensity = None
            n_valid = 0
        else:
            db, intensity = self._export(pair_abs(sig), jnp.asarray(count))
            n_valid = stft_frame_count(count, wl, self.op.hop)

        gathered = gather_to_all({
            "waterfall": out.waterfall,
            "range": out.range,
            "speed": out.speed,
            "detected": out.detected,
            "db": db if db is not None else np.zeros((self.op.num_bins, 0)),
            "intensity": (intensity if intensity is not None
                          else np.zeros((cfg.algorithm.max_freq_bins, 0))),
        })
        times = np.asarray(self.stft.times(sig.shape[0]))[:n_valid]
        log_bins = np.asarray(
            log_bins_axis(self.stft.freqs, cfg.algorithm.max_freq_bins)
        )
        payload = spectrogram_payload(
            times, log_bins, gathered["intensity"][:, :n_valid]
        )
        return {
            "waterfall": gathered["waterfall"].T,  # (K, F) as RadarPipeline
            "range": gathered["range"],
            "speed": gathered["speed"],
            "detected": gathered["detected"],
            "spectrogram_db": gathered["db"][:, :n_valid],
            "spectrogram_intensity": gathered["intensity"][:, :n_valid],
            "spectrogram_times": times,
            "payload": payload,
        }
