"""bench.py's peak table."""

import pytest

import bench


def test_unknown_device_is_an_error():
    """The CPU test backend has no peak entry: asking for one raises
    instead of returning an empty roofline."""
    with pytest.raises(RuntimeError, match="no peak table"):
        bench.chip_peaks()


def test_h100_peaks(monkeypatch):
    import jax

    class Dev:
        device_kind = "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    assert bench.chip_peak_hbm_gbps() == 3350.0
    assert bench.chip_peak_flops() == 989e12
    assert bench.chip_peaks()["tf32_flops"] == 495e12
