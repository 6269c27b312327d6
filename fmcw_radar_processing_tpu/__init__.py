"""fmcw_radar_processing_tpu — an FMCW radar processing framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of the reference system
`alepnabil/fmcw_radar_processing` (an Azure/MATLAB IoT radar ETL + ML
pipeline). This is NOT a port: the MATLAB per-frame serial loop becomes
batched matmuls over a whole recording, detection becomes vectorized masked
top-k, the STFT becomes a framed matmul with sharded overlap-save, and the
VGG16 Keras classifier becomes a Flax model trained with optax/orbax.

Subpackages
-----------
config    typed radar/device/algorithm configuration (radar_processing.m:89-154)
io        Infineon raw-format parser, synthetic IQ generator, storage backends
dsp       windows, fast-time (range) chain, detection, slow-time (Doppler), STFT
pipeline  end-to-end recording pipelines + JSON payload builders
parallel  mesh/sharding/halo-exchange utilities (multi-chip)
models    Flax classifier (VGG16-style) + training + checkpointing
serve     service handler (radar_processing_with_azure.m equivalent) + CLI
"""

__version__ = "0.1.0"

from fmcw_radar_processing_tpu.config import (  # noqa: F401
    AlgorithmConfig,
    DerivedParams,
    DeviceConfig,
    RadarConfig,
)
