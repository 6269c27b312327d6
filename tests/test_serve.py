"""Service handler + CLI end-to-end against local storage."""

import json
import os

import numpy as np
import pytest

from fmcw_radar_processing_tpu.config import RadarConfig, default_device_config
from fmcw_radar_processing_tpu.io.raw_format import write_recording
from fmcw_radar_processing_tpu.io.storage import LocalStorage
from fmcw_radar_processing_tpu.io.synth import SyntheticTarget, synthesize_recording
from fmcw_radar_processing_tpu.serve.cli import main as cli_main
from fmcw_radar_processing_tpu.serve.handler import HandlerConfig, RadarService


@pytest.fixture
def blob_root(tmp_path):
    """A local 'blob container' seeded with a synthetic recording."""
    cfg = RadarConfig.create(default_device_config())
    present = np.ones(40, bool)
    present[5:9] = False
    rec = synthesize_recording(
        cfg, 40,
        (SyntheticTarget(range_m=7.5, doppler_bin_offset=3,
                         md_phase_rad=0.8, md_rate_hz=30.0),),
        target_present=present, seed=7,
    )
    root = tmp_path / "blobs"
    store = LocalStorage(str(root))
    base = tmp_path / "radar_data"
    xml, bin_ = write_recording(str(base), rec)
    store.put(xml, "radar_data.xml", "application/xml")
    store.put(bin_, "radar_data.raw.bin", "application/octet-stream")
    return str(root)


def test_handler_full_mode(blob_root, tmp_path):
    work = tmp_path / "work"
    work.mkdir()
    svc = RadarService(HandlerConfig(workdir=str(work),
                                     storage_spec=f"local:{blob_root}"))
    result = svc.main({"processAnimalActivity": "no"})
    assert result["status"] == "success", result
    assert [s["step"] for s in result["steps"]] == [
        "Read Files", "Radar Processing", "Upload JSON",
    ]
    # The four JSON artifacts + PNG exist locally AND in the blob store.
    for name in [
        "spectrogram_data.json",
        "radar_data_range_fft_data.json",
        "radar_data_range_speed_data.json",
        "radar_data_fft_data.json",
        "spectrogram.png",
    ]:
        assert (work / name).exists(), name
        assert os.path.exists(os.path.join(blob_root, name)), name
    spec = json.loads((work / "spectrogram_data.json").read_text())
    assert len(spec["frequency"]) == 1024
    # PNG is a real image.
    from PIL import Image

    img = Image.open(work / "spectrogram.png")
    assert img.size == (1200, 800)


def test_handler_production_profile(blob_root, tmp_path):
    """profile='production' (AlgorithmConfig.production): same contract
    and artifacts, 256-bucket STFT instead of next-pow-2 fidelity."""
    work = tmp_path / "work"
    work.mkdir()
    svc = RadarService(HandlerConfig(workdir=str(work),
                                     storage_spec=f"local:{blob_root}",
                                     profile="production"))
    result = svc.main({"processAnimalActivity": "no"})
    assert result["status"] == "success", result
    spec = json.loads((work / "spectrogram_data.json").read_text())
    assert len(spec["frequency"]) == 1024
    assert all(np.isfinite(v) for row in spec["intensity"] for v in row)


def test_handler_activity_mode(blob_root, tmp_path):
    work = tmp_path / "work"
    work.mkdir()
    svc = RadarService(HandlerConfig(workdir=str(work),
                                     storage_spec=f"local:{blob_root}"))
    result = svc.main({"processAnimalActivity": "yes"})
    assert result["status"] == "success", result
    batch_files = [f for f in os.listdir(work) if "spectrogram_batch" in f]
    assert batch_files, "activity mode produced no batch spectrograms"


def test_handler_missing_files_fails_first_step(tmp_path):
    svc = RadarService(HandlerConfig(
        workdir=str(tmp_path), storage_spec=f"local:{tmp_path}/empty",
        retries=1,
    ))
    result = svc.main({})
    assert result["status"] == "error"
    assert result["steps"][0]["step"] == "Read Files"
    assert result["steps"][0]["status"] == "error"
    assert result["message"] == "Failed at reading files from blob storage."


def test_handler_default_flag_is_no(blob_root, tmp_path):
    svc = RadarService(HandlerConfig(workdir=str(tmp_path),
                                     storage_spec=f"local:{blob_root}"))
    result = svc.main({})  # no flag → 'no' (radar_processing_with_azure.m:15)
    assert result["status"] == "success"
    assert any("range_fft" in a
               for s in result["steps"] if s.get("artifacts")
               for a in s["artifacts"])


def test_cli_synth_and_process(tmp_path):
    base = str(tmp_path / "rec")
    assert cli_main(["synth", base, "--frames", "24"]) == 0
    outdir = str(tmp_path / "out")
    assert cli_main(["process", base, "--output-dir", outdir]) == 0
    assert os.path.exists(os.path.join(outdir, "rec_range_fft_data.json"))
    assert os.path.exists(os.path.join(outdir, "spectrogram.png"))


def test_cli_config(tmp_path):
    base = str(tmp_path / "rec")
    cli_main(["synth", base, "--frames", "2"])
    assert cli_main(["config", base + ".xml"]) == 0


_IMPORT_PROBE = r"""
import os, sys
from fmcw_radar_processing_tpu.serve import cli
d, mode = sys.argv[1], sys.argv[2]
blob = os.path.join(d, "blob")
os.makedirs(blob)
assert cli.main(["synth", os.path.join(blob, "rec"), "--frames", "24",
                 "--target", "7.5:3"]) == 0
if mode == "process":
    rc = cli.main(["process", os.path.join(blob, "rec"),
                   "--output-dir", os.path.join(d, "out")])
else:
    os.makedirs(os.path.join(d, "work"))
    rc = cli.main(["serve-once", "--fdata", "rec", "--workdir",
                   os.path.join(d, "work"), "--storage", "local:" + blob,
                   "--profile", "production"])
top = {m.split(".")[0] for m in sys.modules}
print(rc, sorted(top & {"PIL", "flax", "orbax", "optax", "tensorflow",
                        "torch", "matplotlib"}))
"""


@pytest.mark.parametrize("mode", ["process", "serve-once"])
def test_signal_path_imports_only_guaranteed_packages(tmp_path, mode):
    """process and serve-once (the /process handler) write every artifact,
    the PNG included, without PIL or the classifier's packages."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c", _IMPORT_PROBE, str(tmp_path), mode],
        cwd=root, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "0 []"
