"""ogl_beamforming_tpu — an ultrasound software beamformer in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
rnpnr/ogl_beamforming (a C11 + Vulkan/GLSL real-time beamformer): Hadamard
decode, FIR filtering/demodulation, delay-and-sum across the FORCES /
HERCULES / RCA acquisition families, coherency weighting, display mapping,
a pipeline planner with trace-time specialization, a streaming runtime, and
the `ogl_beamformer_lib`-compatible client API.

Layout:
  params/    parameter schema, enums, constants (single source of truth)
  utils/     host DSP: Hadamard construction, filter design, voxel transforms
  ops/       compute stages: NumPy golden oracle, plain JAX, a GPU DAS kernel
  pipeline/  pipeline spec -> compiled executable, parameter blocks, stats
  parallel/  device-mesh sharding of the channel axis (psum-accumulated DAS)
  runtime/   streaming ingest, frame backlog, client API
"""

__version__ = "0.1.0"

from .params.constants import API_VERSION  # noqa: F401
from .params.enums import (AcquisitionKind, BeamformerError, DataKind,  # noqa: F401
                           DecodeMode, ErrorKind, FilterKind,
                           InterpolationMode, RCAOrientation, ShaderKind)
from .params.types import (FilterParameters, Parameters,  # noqa: F401
                           SimpleParameters)
