"""chip_smoke.py on the CPU: it refuses to run, and its phases (called
directly, at tiny sizes) pass their oracle checks on the CPU backend."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_without_gpu(tmp_path, alone):
    """No GPU (and, alone, no repo beside it): non-zero exit, no result."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    r = _run_smoke(cwd, script)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU found" in r.stderr


@pytest.mark.parametrize("phase", ["recording", "serve_once", "http",
                                   "fidelity", "streaming", "multi_device"])
def test_phase_tiny(tmp_path, phase):
    fns = {
        "recording": lambda: chip_smoke.phase_recording(frames=64),
        "serve_once": lambda: chip_smoke.phase_serve_once(str(tmp_path),
                                                          frames=32),
        "http": lambda: chip_smoke.phase_http(str(tmp_path), frames=32),
        "fidelity": lambda: chip_smoke.phase_fidelity(str(tmp_path),
                                                      frames=16),
        "streaming": lambda: chip_smoke.phase_streaming(
            channels=2, window=16, windows=3),
        "multi_device": lambda: chip_smoke.phase_multi_device(
            4, frames=64, small_frames=16, channels=4, window=16),
    }
    m = fns[phase]()
    json.dumps(m, default=str)  # every phase reports a JSON-able dict


def test_compare_intensity_rejects_display_error():
    import numpy as np

    want = np.zeros((4, 3))
    with pytest.raises(chip_smoke.SmokeFailure, match="display-band"):
        chip_smoke.compare_intensity(want + 0.2, want, min_snr_db=None,
                                     max_display_db=0.15, what="t")
    m = chip_smoke.compare_intensity(want + 0.1, want, min_snr_db=None,
                                     max_display_db=0.15, what="t")
    assert m["intensity_display_err_db"] == pytest.approx(0.1)
