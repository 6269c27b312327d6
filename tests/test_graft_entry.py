"""__graft_entry__: the jittable forward runs on the current backend, and
the multi-device dry run passes on the virtual CPU mesh."""

import jax
import numpy as np

import __graft_entry__ as graft


def test_entry_forward_runs():
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    assert out["waterfall"].shape == (64, 256)
    assert bool(np.asarray(out["detected"]).any())
    assert np.isfinite(np.asarray(out["spectrogram_intensity"])).all()


def test_dryrun_multichip_on_cpu_mesh():
    graft.dryrun_multichip(4)
