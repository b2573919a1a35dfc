"""clownresampler_tpu — a windowed-sinc audio resampling framework in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
Clownacy/clownresampler (a C89 streaming Lanczos resampler in 16.16 fixed
point): bit-exact numerics, the full four-layer API surface, and batched
multi-stream throughput on an NVIDIA GPU.

Layer map (mirrors SURVEY.md section 1):
  models/       filter models: Lanczos LUT generation (Precompute)
  configure     lowest-level ratio/stretching math (LowestLevel_Configure)
  ops/          the convolution core: XLA oracle + the uniform-ratio launch
                route (LowestLevel_Resample)
  platform      backend check, staging defaults, compile cache
  lowlevel      phase-accumulator streaming over pre-padded input
                (LowLevel_Init/Adjust/Resample)
  highlevel     buffered streaming with automatic edge padding
                (HighLevel_Init/Resample/Adjust/ResampleEnd)
  farm          chunked many-stream transcode farms (the capability the
                scalar reference cannot express)
  batch         batched per-stream-state resampling
  parallel/     device-mesh sharding of stream batches and farms
  utils/        PCM/WAV helpers
"""

from clownresampler_tpu import fixedpoint, platform
from clownresampler_tpu.configure import MAXIMUM_CHANNELS, Configuration, configure
from clownresampler_tpu.farm import MixedStreamFarm, UniformStreamFarm
from clownresampler_tpu.highlevel import HighLevelResampler
from clownresampler_tpu.lowlevel import (
    LowLevelResampler,
    resample_array,
    resample_chunk,
    resample_scan,
    resample_scan_fused,
)
from clownresampler_tpu.models import (
    DEFAULT_MODEL,
    HIGH_QUALITY_MODEL,
    LOW_COST_MODEL,
    KernelModel,
    lanczos_kernel_table,
)

__version__ = "0.1.0"

__all__ = [
    "fixedpoint",
    "Configuration",
    "configure",
    "MAXIMUM_CHANNELS",
    "KernelModel",
    "lanczos_kernel_table",
    "DEFAULT_MODEL",
    "HIGH_QUALITY_MODEL",
    "LOW_COST_MODEL",
    "LowLevelResampler",
    "HighLevelResampler",
    "UniformStreamFarm",
    "MixedStreamFarm",
    "resample_chunk",
    "resample_scan",
    "resample_scan_fused",
    "resample_array",
    "__version__",
]
