"""Robustness-sweep plumbing (tiny sizes — the recorded sweep runs on the accelerator).

Checks that degraded test sets generate through the real chain, the
detection-rate accounting works (high SNR detects, hopeless SNR doesn't),
and the report/markdown round-trips.
"""

import numpy as np

from fmcw_radar_processing_tpu.config import RadarConfig, default_device_config
from fmcw_radar_processing_tpu.models.dataset_gen import CALF, HUMAN
from fmcw_radar_processing_tpu.models.robustness import (
    Condition,
    generate_condition_images,
    input_snr_db,
    robustness_markdown,
    run_robustness_sweep,
    snr_conditions,
)


def test_snr_conditions_hit_requested_snr():
    conds = snr_conditions((CALF, HUMAN), (20.0, 0.0))
    for c, want in zip(conds, (20.0, 0.0)):
        assert abs(input_snr_db((CALF, HUMAN), c) - want) < 1e-6
    # higher noise for lower SNR
    assert conds[1].noise_sigma > conds[0].noise_sigma


def test_degraded_generation_detection_rates(tmp_path):
    classes = (CALF, HUMAN)
    clean = generate_condition_images(
        str(tmp_path / "clean"), classes,
        Condition("clean", noise_sigma=0.05),
        images_per_class=1, frames_per_recording=16,
    )
    assert clean["detection_rate"] > 0.9
    hopeless = generate_condition_images(
        str(tmp_path / "hopeless"), classes,
        # 60 dB below the targets AND amplitude crushed: below threshold.
        Condition("hopeless", noise_sigma=0.05, amp_scale=1e-4),
        images_per_class=1, frames_per_recording=16,
    )
    assert hopeless["detection_rate"] < clean["detection_rate"]


def test_sweep_report_roundtrip(tmp_path):
    report = run_robustness_sweep(
        str(tmp_path),
        model="small",
        train_images_per_class=2,
        test_images_per_class=1,
        frames_per_recording=16,
        epochs=1,
        batch_size=2,
        image_size=(32, 32),
        render_size=(160, 120),
        snr_grid_db=(30.0,),
        extra_conditions=False,
    )
    assert len(report["rows"]) == 1
    row = report["rows"][0]
    assert row["condition"] == "snr_+30dB"
    assert 0.0 <= row["accuracy"] <= 1.0
    md = robustness_markdown(report)
    assert "snr_+30dB" in md and "Break point" in md
    import json
    import os

    assert os.path.exists(tmp_path / "robustness_small.json")
    with open(tmp_path / "robustness_small.json") as f:
        assert json.load(f)["rows"][0]["condition"] == "snr_+30dB"


def test_condition_cache_regenerates_on_param_change(tmp_path):
    """ADVICE r4: the image cache must key on generation parameters, not
    file existence."""
    classes = (CALF, HUMAN)
    d = str(tmp_path / "set")
    a = generate_condition_images(
        d, classes, Condition("c", noise_sigma=0.05),
        images_per_class=1, frames_per_recording=16,
    )
    # Same params → cached (same gen_key round-trips).
    b = generate_condition_images(
        d, classes, Condition("c", noise_sigma=0.05),
        images_per_class=1, frames_per_recording=16,
    )
    assert a == b
    # Changed params → regenerated, not stale.
    import os

    c = generate_condition_images(
        d, classes, Condition("c", noise_sigma=0.05),
        images_per_class=2, frames_per_recording=16,
    )
    assert c["gen_key"] != a["gen_key"]
    assert len(os.listdir(os.path.join(d, "calf"))) == 2


def test_mixture_augmented_sweep(tmp_path):
    """Mixture-augmentation plumbing (r5): train set carries distractor
    mixes, report records the knobs, artifact name gets the suffix."""
    import json
    import os

    report = run_robustness_sweep(
        str(tmp_path),
        model="small",
        train_images_per_class=2,
        test_images_per_class=1,
        frames_per_recording=16,
        epochs=1,
        batch_size=2,
        image_size=(32, 32),
        render_size=(160, 120),
        snr_grid_db=(30.0,),
        extra_conditions=False,
        mixture_augment=True,
        mixture_frac=1.0,
    )
    assert report["mixture_augment"] is True
    assert report["mixture_frac"] == 1.0
    assert os.path.exists(tmp_path / "robustness_small_mixture.json")
    import glob

    assert glob.glob(str(tmp_path / "train_mixture1_0.25-0.85_2x16_*"))
    with open(tmp_path / "robustness_small_mixture.json") as f:
        assert json.load(f)["mixture_augment"] is True
