"""JAX ops vs the NumPy golden oracle (<= 1e-3 NRMSE, BASELINE.md)."""

import numpy as np
import pytest

from helpers import nrmse

from ogl_beamforming_tpu.ops import golden
from ogl_beamforming_tpu.ops.coherency import coherency_weighting as cw_jax
from ogl_beamforming_tpu.ops.das import das_from_params
from ogl_beamforming_tpu.ops.decode import decode_hadamard, hadamard_matrix
from ogl_beamforming_tpu.ops.display import display_map, min_max, sum_frames
from ogl_beamforming_tpu.ops.filtering import demodulate, fir_filter, hilbert
from ogl_beamforming_tpu.params.enums import (AcquisitionKind,
                                              InterpolationMode,
                                              RCAOrientation,
                                              pack_tx_rx_orientation)
from ogl_beamforming_tpu.utils.hadamard import hadamard
from ogl_beamforming_tpu.utils.transforms import das_transform_2d_xz

TOL = 1e-3


@pytest.mark.parametrize("a", [4, 12, 16, 24])
@pytest.mark.parametrize("complex_rf", [False, True])
def test_decode_matches_golden(rng, a, complex_rf):
    c, s = 8, 64
    if complex_rf:
        rf = (rng.standard_normal((c, a, s))
              + 1j * rng.standard_normal((c, a, s))).astype(np.complex64)
    else:
        rf = rng.integers(-2048, 2048, (c, a, s)).astype(np.int16)
    h = hadamard(a)
    ref = golden.decode_hadamard(rf, h)
    out = decode_hadamard(np.asarray(rf), hadamard_matrix(a))
    assert nrmse(ref, np.asarray(out)) < TOL


@pytest.mark.parametrize("decim", [1, 2, 4])
@pytest.mark.parametrize("cx_x,cx_h", [(False, False), (True, False),
                                       (False, True), (True, True)])
def test_fir_matches_golden(rng, decim, cx_x, cx_h):
    shape = (3, 2, 128)
    x = rng.standard_normal(shape).astype(np.float32)
    if cx_x:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    h = rng.standard_normal(17).astype(np.float32)
    if cx_h:
        h = (h + 1j * rng.standard_normal(17)).astype(np.complex64)
    ref = golden.fir_filter(x, h, decim)
    out = np.asarray(fir_filter(x, h, decim))
    assert out.shape == ref.shape
    assert nrmse(ref, out) < TOL


@pytest.mark.parametrize("decim", [1, 2])
@pytest.mark.parametrize("complex_filter", [False, True])
def test_demodulate_matches_golden(rng, decim, complex_filter):
    fs, fd = 40e6, 6.25e6
    x = rng.standard_normal((2, 3, 512)).astype(np.float32)
    h = rng.standard_normal(15).astype(np.float32)
    if complex_filter:
        h = (h + 1j * rng.standard_normal(15)).astype(np.complex64)
    ref = golden.demodulate(x, h, fd, fs, decim, complex_filter)
    out = np.asarray(demodulate(x, h, fd, fs, decim, complex_filter))
    assert out.shape == ref.shape
    assert nrmse(ref, out) < TOL


def test_hilbert_matches_golden(rng):
    x = rng.standard_normal((4, 256)).astype(np.float32)
    assert nrmse(golden.hilbert(x), np.asarray(hilbert(x))) < TOL


def _base_kwargs(c, a, s, nx, nz):
    fs, sos, pitch = 10e6, 1500.0, 0.3e-3
    vt = das_transform_2d_xz([0, 1e-3], [(c - 1) * pitch, 8e-3])
    return dict(acquisition_count=a, channel_count=c, sample_count=s,
                sampling_frequency=fs, speed_of_sound=sos,
                demodulation_frequency=2.5e6, time_offset=1e-7,
                f_number=0.8, voxel_transform=vt,
                xdc_element_pitch=np.array([pitch, pitch], np.float32),
                output_points=(nx, nz, 1))


def _rand_rf(rng, c, a, s, iq):
    x = rng.standard_normal((c, a, s)).astype(np.float32)
    if iq:
        return (x + 1j * rng.standard_normal((c, a, s))).astype(np.complex64)
    return x


@pytest.mark.parametrize("interp", list(InterpolationMode))
@pytest.mark.parametrize("iq", [False, True])
def test_das_forces_matches_golden(rng, interp, iq):
    c, a, s, nx, nz = 8, 4, 128, 12, 16
    p = golden.DasParams(acquisition_kind=AcquisitionKind.FORCES,
                         interpolation_mode=interp,
                         **_base_kwargs(c, a, s, nx, nz))
    rf = _rand_rf(rng, c, a, s, iq)
    ref = golden.das(rf, p)
    out = np.asarray(das_from_params(rf, p, voxel_block=64))
    assert nrmse(ref, out) < TOL


def test_das_uforces_sparse_matches_golden(rng):
    c, a, s, nx, nz = 8, 5, 128, 12, 16
    p = golden.DasParams(acquisition_kind=AcquisitionKind.UFORCES, sparse=True,
                         sparse_elements=np.array([0, 2, 4, 6, 7], np.int16),
                         interpolation_mode=InterpolationMode.Linear,
                         **_base_kwargs(c, a, s, nx, nz))
    rf = _rand_rf(rng, c, a, s, False)
    ref = golden.das(rf, p)
    out = np.asarray(das_from_params(rf, p, voxel_block=128))
    assert nrmse(ref, out) < TOL


@pytest.mark.parametrize("iq", [False, True])
def test_das_hercules_matches_golden(rng, iq):
    c, a, s, nx, nz = 8, 4, 128, 10, 12
    p = golden.DasParams(
        acquisition_kind=AcquisitionKind.HERCULES,
        interpolation_mode=InterpolationMode.Linear,
        transmit_receive_orientation=pack_tx_rx_orientation(
            RCAOrientation.Rows, RCAOrientation.Columns),
        transmit_angle=3.0, focus_depth=np.inf,
        **_base_kwargs(c, a, s, nx, nz))
    rf = _rand_rf(rng, c, a, s, iq)
    ref = golden.das(rf, p)
    out = np.asarray(das_from_params(rf, p, voxel_block=32))
    assert nrmse(ref, out) < TOL


@pytest.mark.parametrize("kind,focus", [
    (AcquisitionKind.Flash, np.inf),
    (AcquisitionKind.RCA_TPW, np.inf),
    (AcquisitionKind.RCA_VLS, 0.02),
])
def test_das_rca_matches_golden(rng, kind, focus):
    c, a, s, nx, nz = 8, 3, 128, 10, 12
    angles = np.array([-5.0, 0.0, 5.0], np.float32)
    fv = np.stack([angles, np.full(3, focus, np.float32)], axis=-1)
    p = golden.DasParams(
        acquisition_kind=kind,
        interpolation_mode=InterpolationMode.Cubic,
        single_focus=False, focal_vectors=fv,
        single_orientation=False,
        transmit_receive_orientations=np.full(
            3, pack_tx_rx_orientation(RCAOrientation.Columns,
                                      RCAOrientation.Columns), np.uint8),
        **_base_kwargs(c, a, s, nx, nz))
    rf = _rand_rf(rng, c, a, s, False)
    ref = golden.das(rf, p)
    out = np.asarray(das_from_params(rf, p, voxel_block=64))
    assert nrmse(ref, out) < TOL


def test_das_readi_forces_matches_golden(rng):
    c, a, g, s, nx, nz = 4, 4, 4, 128, 8, 10
    from ogl_beamforming_tpu.utils.hadamard import hadamard_transpose
    p = golden.DasParams(
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Linear,
        readi_group_count=g, readi_group=2,
        das_hadamard=hadamard_transpose(g),
        **_base_kwargs(c, a, s, nx, nz))
    rf = _rand_rf(rng, c, a, s, False)
    ref = golden.das(rf, p)
    out = np.asarray(das_from_params(rf, p, voxel_block=32))
    assert nrmse(ref, out) < TOL


@pytest.mark.parametrize("iq", [False, True])
def test_das_coherency_matches_golden(rng, iq):
    c, a, s, nx, nz = 6, 4, 128, 8, 10
    p = golden.DasParams(acquisition_kind=AcquisitionKind.FORCES,
                         interpolation_mode=InterpolationMode.Linear,
                         coherency_weighting=True,
                         **_base_kwargs(c, a, s, nx, nz))
    rf = _rand_rf(rng, c, a, s, iq)
    ref_c, ref_i = golden.das(rf, p)
    out_c, out_i = das_from_params(rf, p, voxel_block=32)
    assert nrmse(ref_c, np.asarray(out_c)) < TOL
    assert nrmse(ref_i, np.asarray(out_i)) < TOL
    ref_w = golden.coherency_weighting(ref_c, ref_i)
    out_w = np.asarray(cw_jax(out_c, out_i))
    assert nrmse(ref_w, out_w) < 5e-3  # division amplifies small voxel errors


def test_display_ops_match_golden(rng):
    frames = rng.standard_normal((4, 8, 8)).astype(np.float32)
    assert nrmse(golden.sum_frames(frames), np.asarray(sum_frames(frames))) < TOL
    v = frames[0]
    ref = golden.display_map(v, -50, 0.9, 1.2)
    out = np.asarray(display_map(v, -50.0, 0.9, 1.2))
    assert nrmse(ref, out) < TOL
    lo, hi = min_max(v)
    assert float(lo) == pytest.approx(np.abs(v).min(), rel=1e-5)
    assert float(hi) == pytest.approx(np.abs(v).max(), rel=1e-5)


def test_das_undispatched_kinds_zero(rng):
    """RACES/EPIC/ULM have no das.glsl dispatch case: zero frames."""
    p = golden.DasParams(acquisition_kind=AcquisitionKind.RACES,
                         acquisition_count=2, channel_count=4,
                         sample_count=64, sampling_frequency=1e7,
                         speed_of_sound=1500.0, output_points=(4, 4, 1))
    rf = rng.standard_normal((4, 2, 64)).astype(np.float32)
    assert np.all(golden.das(rf, p) == 0)
    out = das_from_params(rf, p, voxel_block=32)
    assert np.all(np.asarray(out) == 0)


# tests/decode.c:17-19 sweeps this transmit set, including the 12/20-seed
# Kronecker orders.
DECODE_SWEEP_FULL = (2, 4, 8, 12, 16, 20, 24, 32, 40, 48, 64, 80, 96, 128,
                     160, 192, 256)


@pytest.mark.parametrize("a", DECODE_SWEEP_FULL)
def test_decode_full_int16_range_exact(rng, a):
    """Raw RF over the full int16 range decodes exactly (up to the 1/T
    scale) at every order of the reference's sweep: a TF32 product would
    be off by up to 2^-11 relative."""
    c, s = 2, 32
    rf = rng.integers(-32768, 32768, (c, a, s), dtype=np.int16)
    rf[0, 0, :2] = (-32768, 32767)
    ref = np.einsum("tj,cjs->cts", hadamard(a).astype(np.float64),
                    rf.astype(np.float64)) / a
    out = np.asarray(decode_hadamard(rf, hadamard_matrix(a)))
    assert out.shape == ref.shape and out.dtype == np.float32
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("complex_rf", [False, True])
def test_decode_float_input(rng, complex_rf):
    """f32 and complex64 frames (demodulate-first pipelines) decode at
    float32 accuracy."""
    c, a, s = 3, 16, 96
    rf = rng.standard_normal((c, a, s)).astype(np.float32) * 3000
    if complex_rf:
        rf = (rf + 3000j * rng.standard_normal((c, a, s))).astype(
            np.complex64)
    ref = np.einsum("tj,cjs->cts", hadamard(a).astype(np.float64),
                    rf.astype(np.complex128 if complex_rf else np.float64)
                    ) / a
    out = np.asarray(decode_hadamard(rf, hadamard_matrix(a)))
    assert out.dtype == (np.complex64 if complex_rf else np.float32)
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("length", [16, 128])
def test_fir_unrolled_matches_conv(rng, length, monkeypatch):
    """The tap-unrolled FIR and the conv path (taken past
    ``_UNROLL_MAX_TAPS``) give the same strided correlation."""
    from ogl_beamforming_tpu.ops import filtering
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    h = rng.standard_normal(length).astype(np.float32)
    unrolled = np.asarray(filtering._conv1d(x, h, 2))
    monkeypatch.setattr(filtering, "_UNROLL_MAX_TAPS", 0)
    conv = np.asarray(filtering._conv1d(x, h, 2))
    assert nrmse(conv, unrolled) < 1e-6
