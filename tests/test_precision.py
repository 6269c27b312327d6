"""utils/cplx.mxu_precision: what each matmul_precision name runs as."""

import jax
import pytest

from fmcw_radar_processing_tpu.utils.cplx import mxu_precision

P = jax.lax.Precision
GPU = {"default": P.DEFAULT,
       "high": jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3,
       "highest": P.HIGHEST}
CPU = {"default": P.DEFAULT, "high": P.HIGH, "highest": P.HIGHEST}


@pytest.mark.parametrize("backend,table", [("gpu", GPU), ("cpu", CPU)])
@pytest.mark.parametrize("name", ["default", "high", "highest"])
def test_precision_by_platform(monkeypatch, backend, table, name):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert mxu_precision(name) == table[name]


def test_unknown_precision_rejected():
    with pytest.raises(ValueError, match="unknown matmul precision"):
        mxu_precision("tf32")
