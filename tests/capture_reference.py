"""One-time reference-GPU output capture.

Run this ONCE on a machine with a GPU where the reference
(rnpnr/ogl_beamforming) is built and its beamformer app is running:

    # 1. build + start the reference beamformer (it owns the shared memory)
    # 2. point this script at the reference CLIENT library:
    python tests/capture_reference.py /path/to/ogl_beamformer_lib.{so,dll}

It drives the REFERENCE pipeline through its public C ABI (our ctypes
structs are ABI-compatible by construction — runtime/abi.py cross-checks
layouts at load) with the exact deterministic inputs of the committed
point-target fixture, and saves the GLSL shader outputs into
``tests/data/reference_capture/``.  Once those .npy files exist,
``tests/test_reference_capture.py`` compares every compute path
against true reference-GPU output instead of only the NumPy golden model.

Captured cases (all from tests/data/point_targets.zbp, C=32 A=16 S=1024):
  das_linear   : Decode -> DAS, linear interpolation, RF (non-IQ)
  das_cubic    : Decode -> DAS, cubic interpolation, RF (non-IQ)
  das_demod_iq : Demodulate(slot0 Kaiser) -> Decode -> DAS cubic IQ —
                 resolves the documented golden.demodulate phase deviation
                 (ops/golden.py:94-100) against the true shader.

No JAX required on the capture machine — numpy + the reference library.
Reference entry points: lib/ogl_beamformer_lib_base.h:66
(beamformer_beamform_data), tests/throughput.c:150-374 (the setup this
mirrors).
"""

import ctypes as ct
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from ogl_beamforming_tpu.params.enums import (AcquisitionKind, DataKind,  # noqa: E402
                                              FilterKind, InterpolationMode,
                                              ShaderKind)
from ogl_beamforming_tpu.runtime import abi  # noqa: E402
from ogl_beamforming_tpu.utils.zbp import load_zbp  # noqa: E402

OUT_DIR = Path(__file__).parent / "data" / "reference_capture"
FIXTURE = Path(__file__).parent / "data" / "point_targets.zbp"
TIMEOUT_MS = 20_000


def fill_simple(z, *, interpolation, demodulate, nx=64, nz=128):
    """SimpleParameters for the fixture — identical numbers to
    tests/test_fixture.py (LATERAL/AXIAL/NX/NZ/f_number) so captured
    outputs align voxel-for-voxel with our pipeline."""
    from ogl_beamforming_tpu.utils.transforms import das_transform_2d_xz

    sp = abi.CSimpleParameters()
    p = sp.parameters
    c, a, s = z.channel_count, z.receive_event_count, z.sample_count
    pitch = float(z.xdc_element_pitch[0])
    vt = das_transform_2d_xz([0.0, 2e-3], [(c - 1) * pitch, 16e-3])
    p.das_voxel_transform.E[:] = list(np.asarray(vt, np.float32).T.ravel())
    p.xdc_transform.E[:] = list(
        np.asarray(z.xdc_transform, np.float32).T.ravel())
    p.xdc_element_pitch.E[:] = list(map(float, z.xdc_element_pitch))
    p.raw_data_dimensions.E[:] = [a * s, c]
    p.focal_vector.E[:] = [0.0, 0.0]
    p.sample_count = s
    p.channel_count = c
    p.acquisition_count = a
    p.acquisition_kind = int(z.acquisition_kind)
    p.decode_mode = int(z.decode_mode)
    p.time_offset = float(z.time_offset)
    p.single_focus = 1
    p.single_orientation = 1
    p.output_points.E[:] = [nx, nz, 1, 0]
    p.sampling_frequency = float(z.sampling_frequency)
    p.demodulation_frequency = float(z.demodulation_frequency)
    p.speed_of_sound = float(z.speed_of_sound)
    p.f_number = 1.0
    p.interpolation_mode = int(interpolation)
    p.decimation_rate = 1
    for i in range(256):
        sp.channel_mapping[i] = i
    stages = ([ShaderKind.Demodulate] if demodulate else []) + \
        [ShaderKind.Decode, ShaderKind.DAS]
    for i, st in enumerate(stages):
        sp.compute_stages[i] = int(st)
        sp.compute_stage_parameters[i] = 0
    sp.compute_stages_count = len(stages)
    sp.data_kind = int(DataKind.Int16)
    return sp, (nx, nz)


def make_kaiser_filter(lib):
    """Filter slot 0: the Kaiser low-pass of tests/test_fixture.py."""
    fp = abi.FilterParameters()
    fp.kind = int(FilterKind.Kaiser)
    # (cutoff, beta, length) = (2 MHz, 4.0, 16) at the I/Q pair rate fs/2
    # — exactly tests/test_fixture.py's slot-0 filter
    fp.kaiser.cutoff_frequency = 2e6
    fp.kaiser.beta = 4.0
    fp.kaiser.length = 16
    fp.sampling_frequency = 10e6
    fp.complex = 0
    rc = lib.beamformer_create_filter(ct.byref(fp), 0, 0)
    if rc == 0:
        raise RuntimeError("beamformer_create_filter failed: "
                           + lib.beamformer_get_last_error_string().decode())


def capture(lib_path: str):
    z = load_zbp(FIXTURE)
    raw = np.asarray(z.data, np.int16)
    lib = ct.CDLL(lib_path)
    lib.beamformer_get_last_error_string.restype = ct.c_char_p
    lib.beamformer_beamform_data.restype = ct.c_uint32
    lib.beamformer_beamform_data.argtypes = [
        ct.POINTER(abi.CSimpleParameters), ct.c_void_p, ct.c_uint32,
        ct.c_void_p, ct.c_int32]
    lib.beamformer_create_filter.restype = ct.c_uint32
    lib.beamformer_create_filter.argtypes = [
        ct.POINTER(abi.FilterParameters), ct.c_uint8, ct.c_uint8]

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cases = [
        ("das_linear", InterpolationMode.Linear, False),
        ("das_cubic", InterpolationMode.Cubic, False),
        ("das_demod_iq", InterpolationMode.Cubic, True),
    ]
    for name, interp, demod in cases:
        if demod:
            make_kaiser_filter(lib)
        sp, (nx, nz) = fill_simple(z, interpolation=interp, demodulate=demod)
        # IQ pipelines output vec2 per voxel; saved FLAT — the consuming
        # test reshapes and fixes axis order via point-target positions
        out = np.zeros(nx * nz * (2 if demod else 1), np.float32)
        rc = lib.beamformer_beamform_data(
            ct.byref(sp), raw.ctypes.data_as(ct.c_void_p), raw.nbytes,
            out.ctypes.data_as(ct.c_void_p), TIMEOUT_MS)
        if rc == 0:
            raise RuntimeError(
                f"{name}: beamform_data failed: "
                + lib.beamformer_get_last_error_string().decode())
        np.save(OUT_DIR / f"{name}.npy", out)
        print(f"captured {name}: shape={out.shape} "
              f"max={np.abs(out).max():.4g}")
    (OUT_DIR / "MANIFEST").write_text(
        "fixture=point_targets.zbp\n"
        + "".join(f"{n}.npy interpolation={i.name} demodulate={d}\n"
                  for n, i, d in cases))
    print(f"done -> {OUT_DIR}")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    capture(sys.argv[1])
