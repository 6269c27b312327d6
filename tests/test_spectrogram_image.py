"""PNG render fidelity — the classifier's input images.

The reference renders surf(T, F, psd) — the LINEAR-frequency dB PSD —
with ylim [0, 150] Hz, clim [-40, 0] dB, jet colormap
(radar_processing.m:331-348). These tests pin (a) the pixel-level render
against an independent oracle mapping and (b) that the pipeline exposes
the linear-frequency PSD (pre-log-rescale) for the renderer.
"""

import numpy as np
import pytest

from fmcw_radar_processing_tpu.pipeline.spectrogram_image import (
    jet_colormap,
    render_spectrogram_png,
)


def test_jet_colormap_endpoints():
    rgb = jet_colormap(np.array([0.0, 0.5, 1.0]))
    # MATLAB jet: 0 → blue-ish, 0.5 → green-ish, 1 → red-ish.
    assert rgb[0, 2] > 120 and rgb[0, 0] == 0
    assert rgb[1, 1] == 255
    assert rgb[2, 0] > 120 and rgb[2, 2] == 0


def test_render_rows_match_oracle(tmp_path):
    """A single hot frequency row must land at the oracle-computed pixel
    rows, rendered as jet(1.0); everything else at jet(0.0)."""
    PIL = pytest.importorskip("PIL.Image")

    nb, t = 64, 32
    freqs = np.linspace(0.0, 200.0, nb)  # extends past the 150 Hz ylim
    psd = np.full((nb, t), -40.0)
    hot = 24  # freqs[24] ≈ 76.2 Hz — inside the ylim
    psd[hot, :] = 0.0

    w, h = 80, 60
    path = str(tmp_path / "spec.png")
    render_spectrogram_png(path, np.arange(t), freqs, psd, size=(w, h))
    img = np.asarray(PIL.open(path))
    assert img.shape == (h, w, 3)

    # Oracle: replicate the row→frequency mapping independently.
    keep = freqs <= 150.0
    kfreqs = freqs[keep]
    f_lo, f_hi = kfreqs.min(), max(kfreqs.max(), 150.0)
    row_freq = f_hi - (np.arange(h) + 0.5) * (f_hi - f_lo) / h
    fi = np.searchsorted(kfreqs, row_freq).clip(0, len(kfreqs) - 1)
    hot_rows = np.where(fi == hot)[0]
    assert hot_rows.size > 0
    red = jet_colormap(np.array([1.0]))[0]
    blue = jet_colormap(np.array([0.0]))[0]
    for r in hot_rows:
        np.testing.assert_array_equal(img[r, 0], red)
    cold = [r for r in range(h) if r not in set(hot_rows.tolist())]
    for r in cold[:5] + cold[-5:]:
        np.testing.assert_array_equal(img[r, 0], blue)


def test_pipeline_exposes_linear_psd():
    """RecordingOutputs must carry the pre-rescale linear-frequency PSD:
    a uniform frequency axis (log-rescaled bins are not uniform) with one
    column per STFT frame, matching the log-grid intensity columns."""
    from fmcw_radar_processing_tpu.config import (
        AlgorithmConfig,
        RadarConfig,
        default_device_config,
    )
    from fmcw_radar_processing_tpu.io.synth import (
        SyntheticTarget,
        synthesize_recording,
    )
    from fmcw_radar_processing_tpu.pipeline.recording import RadarPipeline

    cfg = RadarConfig.create(
        default_device_config(), AlgorithmConfig(stft_nfft=64)
    )
    rec = synthesize_recording(
        cfg, 12, (SyntheticTarget(range_m=7.5, doppler_bin_offset=3),), seed=3
    )
    pipe = RadarPipeline(cfg)
    out = pipe.process_recording(rec.rx1_pair(), rec.calib_pair(0, cfg.nts))

    lin = out.spectrogram_linear_freqs
    assert lin.shape[0] == 64 // 2 + 1
    steps = np.diff(lin)
    np.testing.assert_allclose(steps, steps[0], rtol=1e-5)  # uniform axis
    log_steps = np.diff(out.spectrogram_freqs)
    assert log_steps[-1] > log_steps[0] * 10  # log grid is NOT uniform
    assert out.spectrogram_psd_db.shape == (
        lin.shape[0], out.spectrogram_intensity.shape[1],
    )
    assert np.max(out.spectrogram_psd_db) == pytest.approx(0.0, abs=1e-4)


def _decode_png_rgb(path):
    """Stdlib decoder for the writer's subset: 8-bit RGB, filter 0."""
    import struct
    import zlib

    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, ctype) == (8, 2)
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()  # filter type 0 on every scanline
    return rows[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (800, 1200)])
def test_png_writer_round_trip(tmp_path, shape):
    """write_png_rgb emits a valid 8-bit RGB PNG that decodes to the same
    pixels, by a stdlib decoder and, where installed, by PIL."""
    from fmcw_radar_processing_tpu.pipeline.spectrogram_image import (
        write_png_rgb,
    )

    rgb = np.random.default_rng(0).integers(
        0, 256, (*shape, 3)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    write_png_rgb(path, rgb)
    np.testing.assert_array_equal(_decode_png_rgb(path), rgb)
    try:
        from PIL import Image
    except ImportError:
        return
    np.testing.assert_array_equal(np.asarray(Image.open(path)), rgb)


def test_png_writer_rejects_non_rgb(tmp_path):
    from fmcw_radar_processing_tpu.pipeline.spectrogram_image import (
        write_png_rgb,
    )

    with pytest.raises(ValueError, match="H, W, 3"):
        write_png_rgb(str(tmp_path / "x.png"), np.zeros((4, 4), np.uint8))
