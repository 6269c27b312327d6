"""SNR-ladder invariants (tools/snr_ladder.py).

The full-map spectrogram dB SNR is bounded by bins below −120 dB, where the
log scale amplifies f32 cancellation error at spectral nulls — physically
invisible (the reference renders clim [−40, 0], radar_processing.m:344).
This test pins the structure of that result on the CPU backend (exact f32
matmuls): high linear-PSD SNR, tight display-band dB error, and the
floor-band origin of the full-map gap.
"""

import numpy as np

from tools.snr_ladder import build_ladder


def test_ladder_structure():
    lad = build_ladder(frames=64, nfft=256, seed=3)

    # Linear-domain stages hold true-f32 accuracy.
    assert lad["1_slow_time_snr_db"] > 110, lad
    assert lad["3_psd_linear_snr_db"] > 110, lad

    # Every displayable bin is sub-0.01 dB accurate.
    disp = lad["intensity_bands"]["display_band_ge_-40dB"]
    assert disp["snr_db"] > 90, lad
    assert disp["max_abs_err_db"] < 0.01, lad
    assert lad["psd_db_bands"]["ge_-120dB"]["max_abs_err_db"] < 0.05, lad

    # The full-map number is capped by the floor band alone: restricting
    # to >= -120 dB recovers >= 40 dB over the full-map figure's class.
    full = lad["4_psd_db_full_snr_db"]
    banded = lad["psd_db_bands"]["ge_-120dB"]["snr_db"]
    assert banded > full, lad
    assert banded > 100, lad

    # And the floor bins really do have large relative linear error
    # (cancellation at nulls) while display bins do not.
    rel = lad["psd_linear_median_rel_err_by_band"]
    assert rel["floor_lt_-120dB"] > 10 * rel["ge_-40dB"], rel
