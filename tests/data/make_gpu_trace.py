"""Record ``gpu_trace.xplane.pb``: a small profiler trace from the GPU.

tests/test_profiling.py checks utils/profiling.py against it.  Run on a
machine with the card, from the repository root:

    python tests/data/make_gpu_trace.py [output path]

The trace holds one call of the DAS kernel on a tiny FORCES frame and one
small XLA reduction; host and Python tracing and the HLO protos are off,
so it carries the device plane and little else.
"""

import glob
import os
import shutil
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from ogl_beamforming_tpu.ops import golden  # noqa: E402
from ogl_beamforming_tpu.ops.das import make_dynamic, make_static  # noqa: E402
from ogl_beamforming_tpu.ops.das_gpu import das_gpu  # noqa: E402
from ogl_beamforming_tpu.params.enums import (AcquisitionKind,  # noqa: E402
                                              InterpolationMode)
from ogl_beamforming_tpu.utils.transforms import das_transform_2d_xz  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "gpu_trace.xplane.pb")


def main(out=OUT):
    if jax.default_backend() != "gpu":
        raise SystemExit("needs a GPU")
    p = golden.DasParams(
        acquisition_kind=AcquisitionKind.FORCES, acquisition_count=4,
        channel_count=8, sample_count=256, sampling_frequency=20e6,
        demodulation_frequency=5e6, speed_of_sound=1500.0,
        interpolation_mode=InterpolationMode.Linear, f_number=0.8,
        voxel_transform=das_transform_2d_xz([0, 1e-3], [7 * 0.3e-3, 8e-3]),
        xdc_element_pitch=np.array([0.3e-3, 0.3e-3], np.float32),
        output_points=(16, 16, 1))
    rf = jnp.asarray(np.random.default_rng(3).standard_normal(
        (8, 4, 256), np.float32))
    st, dyn = make_static(p, iq=False), make_dynamic(p)
    das_fn = jax.jit(lambda x: das_gpu(x, dyn, st))
    reduce_fn = jax.jit(lambda x: jnp.sum(x * 2.0, axis=-1))
    jax.block_until_ready((das_fn(rf), reduce_fn(rf)))
    options = jax.profiler.ProfileOptions()
    options.host_tracer_level = 0
    options.python_tracer_level = 0
    options.enable_hlo_proto = False     # keep compiled programs out
    logdir = tempfile.mkdtemp()
    try:
        with jax.profiler.trace(logdir, profiler_options=options):
            jax.block_until_ready(das_fn(rf))
            jax.block_until_ready(reduce_fn(rf))
        [path] = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                           recursive=True)
        shutil.copyfile(path, out)
    finally:
        shutil.rmtree(logdir)
    print(out, os.path.getsize(out), "bytes")


if __name__ == "__main__":
    main(*sys.argv[1:])
