"""Typed radar configuration.

Three tiers, mirroring the reference's config story
(`radar_processing.m:89-154` and the canonical commented-out schema at
`radar_processing.m:644-672`):

  * :class:`DeviceConfig`  — values parsed from the Infineon device XML
    (`radar_processing.m:94-115`).
  * :class:`AlgorithmConfig` — hard-coded algorithm settings
    (`radar_processing.m:117-129,136,177-190`).
  * :class:`DerivedParams` — theoretical values computed from the two above
    (`radar_processing.m:131-154`).

All three are frozen dataclasses so they hash — they can be passed as static
arguments to `jax.jit`-compiled functions: configuration enters the
compiled graph as compile-time constants (no device transfers, full
constant folding).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Tuple

C0 = 3.0e8  # speed of light in vacuum [m/s] (radar_processing.m:67)


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Radar device configuration (the XML schema of radar_processing.m:94-115)."""

    chirp_duration_ns: float  # BaseEndpoint.chirpDuration_ns
    lower_frequency_khz: float  # FmcwEndpoint.FmcwConfiguration.lowerFrequency_kHz
    upper_frequency_khz: float  # FmcwEndpoint.FmcwConfiguration.upperFrequency_kHz
    num_tx_antennas: int  # BaseEndpoint.DeviceInfo.numAntennasTx
    num_rx_antennas: int  # BaseEndpoint.DeviceInfo.numAntennasRx
    num_samples_per_chirp: int  # BaseEndpoint.FrameFormat.numSamplesPerChirp (NTS)
    num_chirps_per_frame: int  # BaseEndpoint.FrameFormat.numChirpsPerFrame (PN)
    samplerate_hz: float  # AdcxmcEndpoint.AdcxmcConfiguration.samplerateHz

    @property
    def nts(self) -> int:
        return self.num_samples_per_chirp

    @property
    def pn(self) -> int:
        return self.num_chirps_per_frame


@dataclasses.dataclass(frozen=True)
class AlgorithmConfig:
    """Algorithm settings (radar_processing.m:117-129,177-190).

    Defaults are the reference's hard-coded constants.  ``stft_hop`` and
    ``stft_nfft`` generalize the reference's pathological hop-1 /
    nfft=2^nextpow2(L) STFT (radar_processing.m:178-179,273): hop None means
    hop 1 and nfft None means next-pow-2 of the signal length (fidelity
    mode); production configs should set sane values.
    """

    range_fft_size: int = 256  # :118
    doppler_fft_size: int = 16  # :119
    range_threshold: float = 200.0  # :123
    doppler_threshold: float = 50.0  # :124
    min_distance: float = 0.9  # :126
    max_distance: float = 25.0  # :127
    max_num_targets: int = 1  # :129
    frame_time: float = 0.150  # :91 (s)
    down_chirp_duration: float = 200e-6  # :95
    chirp_to_chirp_delay: float = 300e-6  # :96
    stft_window_length: int = 20  # :178
    stft_kaiser_beta: float = 3.0  # kaiser(window_length, 3), :276
    stft_hop: int | None = None  # None => overlap = window-1 (hop 1), :179
    stft_nfft: int | None = None  # None => 2^nextpow2(len), :273
    max_freq_bins: int = 1024  # log-frequency output bins, :293
    batch_size: int = 100  # activity-mode frames per batch, :189
    max_plots: int = 4  # activity-mode spectrogram cap, :443
    # Precision of the chain's f32 matmuls: "default" | "high" | "highest".
    # utils/cplx.mxu_precision says what each runs as on the GPU (one TF32
    # pass / three TF32 passes / full f32 off the tensor cores). One TF32
    # pass keeps about three decimal digits, far short of the 100 dB
    # waterfall criterion, so the default is full f32.
    matmul_precision: str = "highest"
    # Storage dtype of the [1024, T] log-frequency intensity map — the
    # single largest tensor of the chain, and the largest device-to-host
    # transfer. "bfloat16" halves it at a quantization cost of ~±0.125 dB
    # per bin at the display clim (8-bit mantissa on dB values). "int8"
    # quarters it: an affine-quantized dB value over INT8_DB_RANGE
    # (chosen around the reference PNG's clim [−40, 0],
    # radar_processing.m:340 — step ≈ 0.165 dB ⇒ round-to-nearest error
    # ≤ 0.083 dB in-range, within the ≤ 0.15 dB display-band criterion;
    # bins outside the range clamp, which only touches sub-display values).
    # Payloads are converted back to f32 on the host either way.
    intensity_dtype: str = "float32"
    # --- literal-compat flags (SURVEY Appendix A; default = intent) ---
    # Quirk #1: the 'no' branch writes target_measurements.(fr_idx, j) into
    # arrays preallocated zeros(T, F) (radar_processing.m:157-159 vs
    # :245-250) — MATLAB silently grows them, leaving measurements in
    # COLUMN j with zeros (not NaN) elsewhere. True replicates that literal
    # layout in the range_speed payload for byte-parity with a MATLAB run.
    compat_transposed_measurements: bool = False
    # Quirk #2: the fft_data snapshot indexes the 3-D (K, PN, F) FFT cube
    # with 2 subscripts (radar_processing.m:410-411) — MATLAB column-linear
    # indexing returns CHIRP #100 overall (frame 7, chirp 4 at PN=16), raw
    # complex column, not the frame-100 integrated profile. True replicates
    # the literal chirp column.
    compat_linear_index_snapshot: bool = False

    @classmethod
    def production(cls, **overrides) -> "AlgorithmConfig":
        """The production throughput profile.

        Criterion: each EXPORTED artifact is either ≥ 100 dB SNR vs the
        f64 oracle or within 0.15 dB of it in the display band, the
        reference's clim [−40, 0] (radar_processing.m:340). The profile
        pins the STFT to the 256-point bucket, stores the intensity map in
        bfloat16 (≤ 0.125 dB at the clim edge) and runs the chain's
        matmuls at "high" (three TF32 passes on the GPU). The bare
        ``AlgorithmConfig()`` remains the reference-fidelity profile
        (hop-1, nfft = 2^nextpow2(L), f32 artifacts) used by the MPS-parity
        serve path and the oracle tests.
        """
        base: dict = dict(stft_nfft=256, intensity_dtype="bfloat16",
                          matmul_precision="high")
        base.update(overrides)
        return cls(**base)


@dataclasses.dataclass(frozen=True)
class DerivedParams:
    """Theoretical radar values (radar_processing.m:131-154)."""

    prt: float
    bandwidth: float
    carrier_frequency: float
    wavelength: float
    hz_to_mps: float
    if_scale: float
    r_max: float
    dist_per_bin: float
    fd_max: float
    fd_per_bin: float

    def range_axis(self, range_fft_size: int) -> Tuple[float, ...]:
        """array_bin_range (radar_processing.m:149): metres per range bin."""
        return tuple(i * self.dist_per_bin for i in range(range_fft_size))

    def speed_axis(self, doppler_fft_size: int) -> Tuple[float, ...]:
        """array_bin_fD (radar_processing.m:154): m/s per Doppler bin (1-based
        bin b maps to (b - N/2 - 1) * -fd_per_bin * lambda/2)."""
        half = doppler_fft_size // 2
        return tuple(
            (b - half - 1) * -self.fd_per_bin * self.hz_to_mps
            for b in range(1, doppler_fft_size + 1)
        )


def derive(dev: DeviceConfig, alg: AlgorithmConfig) -> DerivedParams:
    """Compute DerivedParams exactly as radar_processing.m:89-154 does."""
    up_chirp = dev.chirp_duration_ns * 1e-9
    prt = up_chirp + alg.down_chirp_duration + alg.chirp_to_chirp_delay  # :97
    bw = (dev.upper_frequency_khz - dev.lower_frequency_khz) * 1e3  # :100
    fc = (dev.upper_frequency_khz + dev.lower_frequency_khz) / 2.0 * 1e3  # :106
    lam = C0 / fc  # :133
    hz_to_mps = lam / 2.0  # :135
    if_scale = 16.0 * 3.3 * alg.range_fft_size / dev.nts  # :121,136
    r_max = dev.nts * C0 / (2.0 * bw)  # :142
    dist_per_bin = r_max / alg.range_fft_size  # :147
    fd_max = 1.0 / (2.0 * prt)  # :152
    fd_per_bin = fd_max / alg.doppler_fft_size  # :153
    return DerivedParams(
        prt=prt,
        bandwidth=bw,
        carrier_frequency=fc,
        wavelength=lam,
        hz_to_mps=hz_to_mps,
        if_scale=if_scale,
        r_max=r_max,
        dist_per_bin=dist_per_bin,
        fd_max=fd_max,
        fd_per_bin=fd_per_bin,
    )


@dataclasses.dataclass(frozen=True)
class RadarConfig:
    """Bundle of device + algorithm config with derived values.

    Hashable ⇒ usable as a `static_argnums` argument under `jax.jit`.
    """

    device: DeviceConfig
    algorithm: AlgorithmConfig
    derived: DerivedParams

    @classmethod
    def create(
        cls, device: DeviceConfig, algorithm: AlgorithmConfig | None = None
    ) -> "RadarConfig":
        algorithm = algorithm or AlgorithmConfig()
        return cls(device=device, algorithm=algorithm, derived=derive(device, algorithm))

    # Convenience accessors used throughout the DSP code
    @property
    def nts(self) -> int:
        return self.device.nts

    @property
    def pn(self) -> int:
        return self.device.pn

    @property
    def range_fft_size(self) -> int:
        return self.algorithm.range_fft_size

    @property
    def doppler_fft_size(self) -> int:
        return self.algorithm.doppler_fft_size

    @property
    def zero_doppler_bin(self) -> int:
        """0-based index of the zero-velocity bin after fftshift.

        The reference hard-codes 1-based bin 9 for doppler_fft_size=16
        (radar_processing.m:234-238); we derive it as N/2 (0-based), which
        equals 9 in 1-based indexing for N=16.
        """
        return self.doppler_fft_size // 2

    def to_json(self) -> str:
        """Export the canonical configuration schema.

        Field names follow the commented-out `fmcw_configurations` struct at
        radar_processing.m:644-672 so dashboards built against the reference
        schema keep working.
        """
        d = self.derived
        a = self.algorithm
        dev = self.device
        obj = {
            "frame_time": a.frame_time,
            "PRT": d.prt,
            "Bandwidth": d.bandwidth,
            "num_Tx_antennas": dev.num_tx_antennas,
            "num_Rx_antennas": dev.num_rx_antennas,
            "carrier_frequency": d.carrier_frequency,
            "num_ADC_samples_per_chirp": dev.nts,
            "num_chirps_per_frame": dev.pn,
            "sampling_frequency": dev.samplerate_hz,
            "range_fft_size": a.range_fft_size,
            "Doppler_fft_size": a.doppler_fft_size,
            "IF_scale": d.if_scale,
            "range_threshold": a.range_threshold,
            "Doppler_threshold": a.doppler_threshold,
            "min_distance": a.min_distance,
            "max_distance": a.max_distance,
            "max_num_targets": a.max_num_targets,
            "lambda": d.wavelength,
            "Hz_to_mps_constant": d.hz_to_mps,
            "R_max": d.r_max,
            "dist_per_bin": d.dist_per_bin,
            "fD_max": d.fd_max,
            "fD_per_bin": d.fd_per_bin,
            "window_length": a.stft_window_length,
            "overlap": a.stft_window_length - (a.stft_hop or 1),
        }
        return json.dumps(obj, indent=2)


def default_device_config() -> DeviceConfig:
    """A representative Infineon 24 GHz config.

    The repo ships no radar_data.xml, so defaults are chosen to reproduce the
    reference's own annotated numbers: NTS=64 and BW=200 MHz give
    R_max = 64*3e8/(2*2e8) = 48 m and dist_per_bin = 48/256 = 0.1875 m,
    matching the comments at radar_processing.m:141-144.
    """
    return DeviceConfig(
        chirp_duration_ns=300_000.0,  # 300 us up-chirp
        lower_frequency_khz=24_025_000.0,
        upper_frequency_khz=24_225_000.0,  # BW = 200 MHz
        num_tx_antennas=1,
        num_rx_antennas=2,
        num_samples_per_chirp=64,
        num_chirps_per_frame=16,
        samplerate_hz=64 / 300e-6,
    )


def next_pow2(n: int) -> int:
    """2^nextpow2(n) (radar_processing.m:273)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()
