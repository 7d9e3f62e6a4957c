"""Compare the JAX pipeline against captured reference-GPU output.

Skipped until tests/data/reference_capture/*.npy exist (generate them ONCE
on a GPU machine with tests/capture_reference.py).  The moment they are
committed, every case here pins our pipeline to true GLSL shader output
instead of only the NumPy golden model.
"""

import os

import numpy as np
import pytest

from helpers import nrmse

CAP_DIR = os.path.join(os.path.dirname(__file__), "data",
                       "reference_capture")


def _load(name):
    path = os.path.join(CAP_DIR, name + ".npy")
    if not os.path.exists(path):
        pytest.skip(f"no reference capture at {path} "
                    "(run tests/capture_reference.py on a GPU machine)")
    return np.load(path)


def _our_frame(interpolation, demodulate):
    from ogl_beamforming_tpu.models.presets import from_zbp
    from ogl_beamforming_tpu.params.enums import FilterKind
    from ogl_beamforming_tpu.params.types import (FilterParameters,
                                                  KaiserFilterParameters)
    from ogl_beamforming_tpu.pipeline.executor import Beamformer
    from ogl_beamforming_tpu.utils.zbp import load_zbp
    fixture = os.path.join(os.path.dirname(__file__), "data",
                           "point_targets.zbp")
    z = load_zbp(fixture)
    pitch = float(z.xdc_element_pitch[0])
    params, pipe = from_zbp(
        z, output_points=(64, 128),
        lateral_mm=(0.0, 31 * pitch * 1e3),
        axial_mm=(2.0, 16.0), f_number=1.0, interpolation=interpolation)
    if not demodulate:
        params.demodulation_frequency = 0.0
        stages = [s.kind for s in pipe.stages
                  if s.kind.name != "Demodulate"]
        stage_params = [0] * len(stages)
    else:
        stages = [s.kind for s in pipe.stages]
        stage_params = [s.parameter for s in pipe.stages]
    bf = Beamformer(voxel_block=4096)
    if demodulate:
        fp = FilterParameters(kind=FilterKind.Kaiser,
                              sampling_frequency=z.sampling_frequency / 2,
                              kaiser=KaiserFilterParameters(2e6, 4.0, 16))
        bf.create_filter(fp, filter_slot=0)
    bf.push_parameters(params)
    bf.push_pipeline(stages, pipe.data_kind, stage_params)
    raw = z.data.reshape(z.channel_count, -1)
    return np.asarray(bf.push_data_with_compute(raw).data)


def _aligned(cap_flat, ours):
    """Reference frames are saved flat; resolve axis order against our
    (possibly complex) frame shape."""
    if np.iscomplexobj(ours):
        cap = cap_flat.reshape(-1, 2)
        cap = cap[:, 0] + 1j * cap[:, 1]
    else:
        cap = cap_flat
    for shape in (ours.shape, ours.shape[::-1]):
        try:
            c = cap.reshape(shape)
        except ValueError:
            continue
        if c.shape != ours.shape:
            c = c.T
        if nrmse(np.abs(ours), np.abs(c)) < 0.5:
            return c
    return cap.reshape(ours.shape)


@pytest.mark.parametrize("name,interp,demod", [
    ("das_linear", "Linear", False),
    ("das_cubic", "Cubic", False),
])
def test_das_matches_reference_gpu(name, interp, demod):
    from ogl_beamforming_tpu.params.enums import InterpolationMode
    cap = _load(name)
    ours = _our_frame(InterpolationMode[interp], demod)
    ref = _aligned(cap, ours)
    assert nrmse(ours, ref) < 1e-3


def test_demod_iq_matches_reference_gpu():
    # golden.demodulate knowingly deviates from the shader's
    # workgroup-local phase (ops/golden.py:94-100); this capture decides
    # who is right.  Tolerance intentionally strict — a failure here is
    # the signal to fix golden, not to relax the bound.
    from ogl_beamforming_tpu.params.enums import InterpolationMode
    cap = _load("das_demod_iq")
    ours = _our_frame(InterpolationMode.Cubic, True)
    ref = _aligned(cap, ours)
    assert nrmse(np.abs(ours), np.abs(ref)) < 1e-3
