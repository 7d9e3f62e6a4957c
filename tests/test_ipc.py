"""Shared-memory IPC: C client library <-> Python server, end to end.

Builds the native library, starts a server thread (CPU-JAX executor),
then drives the reference client ABI through ctypes exactly as an external
C/MATLAB program would (reference: tests/decode.c, tests/throughput.c link
ogl_beamformer_lib and talk over shm).
"""

import ctypes as ct
import os

import numpy as np
import pytest

from helpers import nrmse

pytestmark = pytest.mark.skipif(
    os.environ.get("BF_SKIP_IPC") == "1", reason="IPC disabled")

from ogl_beamforming_tpu.ops import golden
from ogl_beamforming_tpu.params.enums import (AcquisitionKind, DataKind,
                                              ErrorKind, InterpolationMode,
                                              ShaderKind)
from ogl_beamforming_tpu.runtime import abi
from ogl_beamforming_tpu.runtime.server import BeamformerServer
from ogl_beamforming_tpu.utils.hadamard import hadamard
from ogl_beamforming_tpu.utils.transforms import das_transform_2d_xz


@pytest.fixture(scope="module")
def server():
    os.environ["OGL_BEAMFORMER_SHM_NAME"] = f"/bf_test_{os.getpid()}"
    srv = BeamformerServer(shm_size=64 << 20)
    srv.start()
    yield srv
    srv.stop()


def _fill_simple(c=8, a=4, s=256, nx=12, nz=16):
    sp = abi.CSimpleParameters()
    p = sp.parameters
    pitch = 0.3e-3
    vt = das_transform_2d_xz([0, 1e-3], [(c - 1) * pitch, 8e-3])
    # row-major numpy -> column-major reference m4
    p.das_voxel_transform.E[:] = list(np.asarray(vt, np.float32).T.ravel())
    eye = np.eye(4, dtype=np.float32)
    p.xdc_transform.E[:] = list(eye.T.ravel())
    p.xdc_element_pitch.E[:] = [pitch, pitch]
    p.raw_data_dimensions.E[:] = [a * s, c]
    p.focal_vector.E[:] = [0.0, 0.0]
    p.sample_count = s
    p.channel_count = c
    p.acquisition_count = a
    p.acquisition_kind = int(AcquisitionKind.FORCES)
    p.decode_mode = 1
    p.time_offset = 0.0
    p.single_focus = 1
    p.single_orientation = 1
    p.output_points.E[:] = [nx, nz, 1, 0]
    p.sampling_frequency = 20e6
    p.demodulation_frequency = 5e6
    p.speed_of_sound = 1500.0
    p.f_number = 0.8
    p.interpolation_mode = int(InterpolationMode.Linear)
    p.decimation_rate = 1
    for i in range(256):
        sp.channel_mapping[i] = i
    sp.compute_stages[0] = int(ShaderKind.Decode)
    sp.compute_stages[1] = int(ShaderKind.DAS)
    sp.compute_stages_count = 2
    sp.data_kind = int(DataKind.Int16)
    return sp


def test_api_version(server):
    assert server.lib.beamformer_get_api_version() == 34


def test_error_strings(server):
    s = server.lib.beamformer_error_string(int(ErrorKind.WorkQueueFull))
    assert s == b"work queue full"


def test_beamform_data_end_to_end(server, rng):
    c, a, s, nx, nz = 8, 4, 256, 12, 16
    sp = _fill_simple(c, a, s, nx, nz)
    raw = rng.integers(-1024, 1024, (c, a * s)).astype(np.int16)
    out = np.zeros(nx * nz, np.float32)

    ok = server.lib.beamformer_beamform_data(
        ct.byref(sp), raw.ctypes.data_as(ct.c_void_p), raw.nbytes,
        out.ctypes.data_as(ct.c_void_p), 15000)
    assert ok == 1, server.lib.beamformer_get_last_error_string()

    # Golden: decode + DAS; exported layout is x-fastest
    rf = raw.reshape(c, a, s)
    dec = golden.decode_hadamard(rf, hadamard(a))
    dp = golden.DasParams(
        acquisition_kind=AcquisitionKind.FORCES, acquisition_count=a,
        channel_count=c, sample_count=s, sampling_frequency=20e6,
        demodulation_frequency=5e6, speed_of_sound=1500.0,
        interpolation_mode=InterpolationMode.Linear, f_number=0.8,
        voxel_transform=das_transform_2d_xz([0, 1e-3],
                                            [(c - 1) * 0.3e-3, 8e-3]),
        xdc_element_pitch=np.array([0.3e-3, 0.3e-3], np.float32),
        output_points=(nx, nz, 1))
    ref = golden.das(rf=dec, p=dp)
    ref_flat = np.asarray(ref).transpose(2, 1, 0).ravel()
    assert nrmse(ref_flat, out) < 1e-3


def test_push_and_compute_advanced(server, rng):
    """Advanced API: push parameters/pipeline separately, then data."""
    lib = server.lib
    sp = _fill_simple()
    assert lib.beamformer_push_simple_parameters(ct.byref(sp)) == 1

    raw = rng.integers(-512, 512, (8, 4 * 256)).astype(np.int16)
    assert lib.beamformer_push_data_with_compute(
        raw.ctypes.data_as(ct.c_void_p), raw.nbytes, 0, 0) == 1

    out = np.zeros(12 * 16, np.float32)
    lib.beamformer_set_global_timeout(15000)
    assert lib.beamformer_get_last_frames(
        out.ctypes.data_as(ct.c_void_p), out.nbytes, 1) == 1
    lib.beamformer_set_global_timeout(0)
    assert np.abs(out).max() > 0


def test_compute_timings_export(server):
    stats = abi.CStatsTable()
    assert server.lib.beamformer_compute_timings(ct.byref(stats), 1000) == 1
    ids = list(stats.shader_ids)
    assert int(ShaderKind.DAS) in ids


def test_client_errors(server, rng):
    lib = server.lib
    # bad image plane
    raw = np.zeros(16, np.int16)
    assert lib.beamformer_push_data_with_compute(
        raw.ctypes.data_as(ct.c_void_p), raw.nbytes, 99, 0) == 0
    assert lib.beamformer_get_last_error() == int(ErrorKind.InvalidImagePlane)
    # bad pipeline start
    stages = (ct.c_int32 * 1)(int(ShaderKind.DAS))
    assert lib.beamformer_push_pipeline(stages, 1, int(DataKind.Int16)) == 0
    assert lib.beamformer_get_last_error() == int(ErrorKind.InvalidStartShader)
    # data size mismatch
    sp = _fill_simple()
    assert lib.beamformer_push_simple_parameters(ct.byref(sp)) == 1
    assert lib.beamformer_push_data_with_compute(
        raw.ctypes.data_as(ct.c_void_p), raw.nbytes, 0, 0) == 0
    assert lib.beamformer_get_last_error() == int(ErrorKind.DataSizeMismatch)


def test_cross_process_c_client(server, rng, tmp_path):
    """A real compiled C client in a separate process drives the server
    through the shared-memory ABI — the reference's tests/decode.c shape."""
    import subprocess
    from pathlib import Path

    from ogl_beamforming_tpu.params.codegen import write_generated

    repo = Path(__file__).resolve().parent.parent
    gen = tmp_path / "gen"
    write_generated(gen)
    src = tmp_path / "client.c"
    src.write_text(r'''
#include "ogl_beamformer_lib.h"
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
int main(void) {
    if (beamformer_get_api_version() != 34) return 2;
    BeamformerSimpleParameters sp;
    memset(&sp, 0, sizeof sp);
    float eye[16] = {1,0,0,0, 0,1,0,0, 0,0,1,0, 0,0,0,1};
    /* 2D xz transform: lateral 0..2.1mm (col 0), axial 1..8mm (col 1) */
    float vt[16] = {0.0021f,0,0,0, 0,0,0.007f,0, 0,1,0,0, 0,0,0.001f,1};
    memcpy(sp.parameters.das_voxel_transform, vt, sizeof vt);
    memcpy(sp.parameters.xdc_transform, eye, sizeof eye);
    sp.parameters.xdc_element_pitch[0] = 0.0003f;
    sp.parameters.xdc_element_pitch[1] = 0.0003f;
    sp.parameters.raw_data_dimensions[0] = 4 * 256;
    sp.parameters.raw_data_dimensions[1] = 8;
    sp.parameters.sample_count = 256;
    sp.parameters.channel_count = 8;
    sp.parameters.acquisition_count = 4;
    sp.parameters.decode_mode = BeamformerDecodeMode_Hadamard;
    sp.parameters.single_focus = 1;
    sp.parameters.single_orientation = 1;
    sp.parameters.output_points[0] = 12;
    sp.parameters.output_points[1] = 16;
    sp.parameters.output_points[2] = 1;
    sp.parameters.sampling_frequency = 20e6f;
    sp.parameters.speed_of_sound = 1500.0f;
    sp.parameters.f_number = 0.8f;
    sp.parameters.interpolation_mode = BeamformerInterpolationMode_Linear;
    sp.parameters.decimation_rate = 1;
    for (int i = 0; i < 256; i++) sp.channel_mapping[i] = (int16_t)i;
    sp.compute_stages[0] = BeamformerShaderKind_Decode;
    sp.compute_stages[1] = BeamformerShaderKind_DAS;
    sp.compute_stages_count = 2;
    sp.data_kind = BeamformerDataKind_Int16;

    int16_t *data = malloc(8 * 4 * 256 * sizeof(int16_t));
    for (int i = 0; i < 8 * 4 * 256; i++) data[i] = (int16_t)((i * 2654435761u) >> 22);
    float *out = calloc(12 * 16, sizeof(float));
    if (!beamformer_beamform_data(&sp, data, 8*4*256*2, out, 30000)) {
        fprintf(stderr, "beamform failed: %s\n", beamformer_get_last_error_string());
        return 3;
    }
    float peak = 0;
    for (int i = 0; i < 12 * 16; i++) if (out[i] > peak || -out[i] > peak)
        peak = out[i] > 0 ? out[i] : -out[i];
    printf("PEAK %f\n", peak);
    return peak > 0 ? 0 : 4;
}
''')
    exe = tmp_path / "client"
    native = repo / "ogl_beamforming_tpu" / "runtime" / "native"
    subprocess.run(
        ["cc", str(src), "-I", str(gen), "-L", str(native),
         "-logl_beamformer_tpu", "-o", str(exe)],
        check=True, capture_output=True)
    env = dict(os.environ)
    env["LD_LIBRARY_PATH"] = str(native)
    result = subprocess.run([str(exe)], env=env, capture_output=True,
                            text=True, timeout=60)
    assert result.returncode == 0, (result.stdout, result.stderr)
    assert "PEAK" in result.stdout


def test_live_imaging_bridge(server):
    """Server-side live updates propagate to clients' dirty-flag poll."""
    from ogl_beamforming_tpu.params.enums import LiveImagingDirtyFlags
    lib = server.lib

    server.set_live(transmit_power=0.75, active=1,
                    dirty_flags=int(LiveImagingDirtyFlags.TransmitPower))
    live = lib.beamformer_get_live_parameters()
    assert abs(live.contents.transmit_power - 0.75) < 1e-6
    # client polls one flag at a time (lowest set)
    flag = lib.beamformer_live_parameters_get_dirty_flag()
    assert flag == 1  # TransmitPower bit index
    assert lib.beamformer_live_parameters_get_dirty_flag() == -1

    # client -> server direction
    live.contents.save_enabled = 1
    new = abi.CLiveImagingParameters()
    ct.memmove(ct.byref(new), live, ct.sizeof(new))
    new.transmit_power = 0.5
    assert lib.beamformer_set_live_parameters(ct.byref(new)) == 1
    assert abs(server.get_live().transmit_power - 0.5) < 1e-6


def test_multi_block_and_capacity_queries(server, rng):
    """Parameter-block reservation, _at variants, and capacity queries."""
    lib = server.lib
    assert lib.beamformer_reserve_parameter_blocks(3) == 1

    sp = _fill_simple(nx=8, nz=8)
    assert lib.beamformer_push_simple_parameters_at(ct.byref(sp), 2) == 1
    raw = rng.integers(-512, 512, (8, 4 * 256)).astype(np.int16)
    assert lib.beamformer_push_data_with_compute(
        raw.ctypes.data_as(ct.c_void_p), raw.nbytes, 0, 2) == 1

    lib.beamformer_set_global_timeout(15000)
    out = np.zeros(8 * 8, np.float32)
    assert lib.beamformer_get_last_frames(
        out.ctypes.data_as(ct.c_void_p), out.nbytes, 1) == 1
    lib.beamformer_set_global_timeout(0)
    assert np.abs(out).max() > 0

    # capacity queries
    assert lib.beamformer_maximum_rf_data_size() > 1 << 20
    n = lib.beamformer_maximum_frames_for_parameters(
        ct.byref(sp.parameters))
    assert 0 < n < (1 << 63)

    # unreserved block rejected
    assert lib.beamformer_push_simple_parameters_at(ct.byref(sp), 9) == 0
    from ogl_beamforming_tpu.params.enums import ErrorKind
    assert lib.beamformer_get_last_error() == \
        int(ErrorKind.ParameterBlockUnallocated)


def test_queue_stress_sanitizers():
    """Multi-producer queue claim/commit protocol under TSan + ASan/UBSan
    (the publish race in beamformer_lib.c queue_push/queue_pop)."""
    import shutil
    import subprocess
    native = os.path.join(os.path.dirname(abi.__file__), "native")
    if shutil.which("cc") is None:
        pytest.skip("no C compiler")
    build = subprocess.run(["make", "-C", native, "stress"],
                           capture_output=True, text=True)
    if build.returncode != 0:
        pytest.skip(f"sanitizer toolchain unavailable: {build.stderr[-200:]}")
    for exe in ["queue_stress", "queue_stress_tsan", "queue_stress_asan"]:
        run = subprocess.run([os.path.join(native, exe)],
                             capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, f"{exe}: {run.stdout} {run.stderr[-500:]}"


def test_beamform_data_float32complex(server, rng):
    """C-ABI round trip with interleaved Float32Complex raw data
    (reference: shaders/reshape.glsl:30-82, lib/ogl_beamformer_lib.c:491-570)."""
    c, a, s, nx, nz = 8, 4, 256, 12, 16
    sp = _fill_simple(c, a, s, nx, nz)
    sp.data_kind = int(DataKind.Float32Complex)
    wire = rng.standard_normal((c, a * s * 2)).astype(np.float32)
    out = np.zeros(nx * nz, np.complex64)

    ok = server.lib.beamformer_beamform_data(
        ct.byref(sp), wire.ctypes.data_as(ct.c_void_p), wire.nbytes,
        out.ctypes.data_as(ct.c_void_p), 15000)
    assert ok == 1, server.lib.beamformer_get_last_error_string()

    pairs = wire.reshape(c, a, s * 2)
    rf = (pairs[..., 0::2] + 1j * pairs[..., 1::2]).astype(np.complex64)
    dec = golden.decode_hadamard(rf, hadamard(a))
    dp = golden.DasParams(
        acquisition_kind=AcquisitionKind.FORCES, acquisition_count=a,
        channel_count=c, sample_count=s, sampling_frequency=20e6,
        demodulation_frequency=5e6, speed_of_sound=1500.0,
        interpolation_mode=InterpolationMode.Linear, f_number=0.8,
        voxel_transform=das_transform_2d_xz([0, 1e-3],
                                            [(c - 1) * 0.3e-3, 8e-3]),
        xdc_element_pitch=np.array([0.3e-3, 0.3e-3], np.float32),
        output_points=(nx, nz, 1))
    ref = golden.das(rf=dec, p=dp)
    ref_flat = np.asarray(ref).transpose(2, 1, 0).ravel()
    assert nrmse(ref_flat, out) < 1e-3


def test_beamform_data_int16complex(server, rng):
    """C-ABI round trip with interleaved Int16Complex raw data."""
    c, a, s, nx, nz = 8, 4, 256, 12, 16
    sp = _fill_simple(c, a, s, nx, nz)
    sp.data_kind = int(DataKind.Int16Complex)
    wire = rng.integers(-1024, 1024, (c, a * s * 2)).astype(np.int16)
    out = np.zeros(nx * nz, np.complex64)

    ok = server.lib.beamformer_beamform_data(
        ct.byref(sp), wire.ctypes.data_as(ct.c_void_p), wire.nbytes,
        out.ctypes.data_as(ct.c_void_p), 15000)
    assert ok == 1, server.lib.beamformer_get_last_error_string()

    pairs = wire.reshape(c, a, s * 2).astype(np.float32)
    rf = (pairs[..., 0::2] + 1j * pairs[..., 1::2]).astype(np.complex64)
    dec = golden.decode_hadamard(rf, hadamard(a))
    dp = golden.DasParams(
        acquisition_kind=AcquisitionKind.FORCES, acquisition_count=a,
        channel_count=c, sample_count=s, sampling_frequency=20e6,
        demodulation_frequency=5e6, speed_of_sound=1500.0,
        interpolation_mode=InterpolationMode.Linear, f_number=0.8,
        voxel_transform=das_transform_2d_xz([0, 1e-3],
                                            [(c - 1) * 0.3e-3, 8e-3]),
        xdc_element_pitch=np.array([0.3e-3, 0.3e-3], np.float32),
        output_points=(nx, nz, 1))
    ref = golden.das(rf=dec, p=dp)
    ref_flat = np.asarray(ref).transpose(2, 1, 0).ravel()
    assert nrmse(ref_flat, out) < 1e-3


def test_server_stop_imaging(server, rng):
    """StopImaging halts the server's compute loop until active again
    (reference: live-control plumbing, tests/throughput.c:558-560)."""
    import time
    from ogl_beamforming_tpu.params.enums import LiveImagingDirtyFlags
    lib = server.lib
    sp = _fill_simple()
    assert lib.beamformer_push_simple_parameters(ct.byref(sp)) == 1
    raw = rng.integers(-512, 512, (8, 4 * 256)).astype(np.int16)

    def push():
        return lib.beamformer_push_data_with_compute(
            raw.ctypes.data_as(ct.c_void_p), raw.nbytes, 0, 0)

    lib.beamformer_set_global_timeout(15000)
    assert push() == 1
    out = np.zeros(12 * 16, np.float32)
    assert lib.beamformer_get_last_frames(
        out.ctypes.data_as(ct.c_void_p), out.nbytes, 1) == 1
    n0 = server.beamformer._frame_id

    # UI side requests stop: active = 0 + StopImaging dirty flag
    server.set_live(dirty_flags=int(LiveImagingDirtyFlags.StopImaging),
                    active=0)
    assert push() == 1            # accepted but dropped
    for s in server._sessions.values():
        s.flush()
    time.sleep(0.2)
    assert server.beamformer._frame_id == n0

    # restart
    server.set_live(active=1)
    assert push() == 1
    for s in server._sessions.values():
        s.flush()
    deadline = time.time() + 10
    while server.beamformer._frame_id == n0 and time.time() < deadline:
        time.sleep(0.05)
    assert server.beamformer._frame_id == n0 + 1
    lib.beamformer_set_global_timeout(0)
