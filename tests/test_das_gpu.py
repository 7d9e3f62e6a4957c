"""GPU DAS kernel (ops/das_gpu.py) vs the golden oracle.

On the CPU the kernel runs in Pallas interpret mode, which checks its
arithmetic, tiling and padding; tests marked ``gpu`` compile it for the
card and compare it with ops/das.py there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helpers import nrmse

from ogl_beamforming_tpu.ops import das_gpu, golden
from ogl_beamforming_tpu.ops.das import das, make_dynamic, make_static
from ogl_beamforming_tpu.params.enums import (AcquisitionKind,
                                              InterpolationMode,
                                              RCAOrientation,
                                              pack_tx_rx_orientation)
from ogl_beamforming_tpu.utils.hadamard import hadamard_transpose
from ogl_beamforming_tpu.utils.transforms import (das_transform_2d_xz,
                                                  das_transform_3d)

TOL = 1e-3
PITCH = 0.3e-3
ROWS_COLS = pack_tx_rx_orientation(RCAOrientation.Rows,
                                   RCAOrientation.Columns)


def _params(c, a, s, out_points, kind, **kw):
    if len([d for d in out_points if d > 1]) == 3:
        ap = (c - 1) * PITCH
        vt = das_transform_3d([0, 0, 1e-3], [ap, ap, 8e-3])
    else:
        vt = das_transform_2d_xz([0, 1e-3], [(c - 1) * PITCH, 8e-3])
    return golden.DasParams(
        acquisition_kind=kind, acquisition_count=a, channel_count=c,
        sample_count=s, sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, time_offset=1e-7, f_number=0.8,
        voxel_transform=vt,
        xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
        output_points=out_points, **kw)


def _rca_kw(a, focus, orient):
    angles = np.linspace(-5.0, 5.0, a).astype(np.float32)
    return dict(single_focus=False, single_orientation=False,
                focal_vectors=np.stack(
                    [angles, np.full(a, focus, np.float32)], axis=-1),
                transmit_receive_orientations=np.full(
                    a, pack_tx_rx_orientation(orient, orient), np.uint8))


def _family_params(family, interp=InterpolationMode.Linear, **kw):
    """One small configuration per kernel family."""
    if family == "forces":
        return _params(8, 4, 256, (12, 16, 1), AcquisitionKind.FORCES,
                       interpolation_mode=interp, **kw)
    if family == "hercules":
        return _params(8, 4, 256, (8, 8, 12), AcquisitionKind.HERCULES,
                       transmit_receive_orientation=ROWS_COLS,
                       transmit_angle=3.0, focus_depth=np.inf,
                       interpolation_mode=interp, **kw)
    return _params(8, 3, 256, (12, 16, 1), AcquisitionKind.RCA_TPW,
                   interpolation_mode=interp,
                   **_rca_kw(3, np.inf, RCAOrientation.Columns), **kw)


def _rf(rng, p, iq, batch=()):
    shape = batch + (p.channel_count, p.acquisition_count, p.sample_count)
    rf = rng.standard_normal(shape).astype(np.float32)
    if iq:
        rf = (rf + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return rf


def _kernel(rf, p, iq, dyn=None, **replace):
    st = dataclasses.replace(make_static(p, iq=iq), **replace)
    return das_gpu.das_gpu(jnp.asarray(rf), dyn or make_dynamic(p), st,
                           interpret=True)


def _check(ref, out):
    if isinstance(ref, tuple):
        for r, o in zip(ref, out):
            assert np.abs(r).max() > 0
            assert nrmse(r, np.asarray(o)) < TOL
    else:
        assert np.abs(np.asarray(ref)).max() > 0
        assert nrmse(ref, np.asarray(out)) < TOL


@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("interp", list(InterpolationMode))
@pytest.mark.parametrize("family", ["forces", "hercules", "rca"])
def test_family_matches_golden(rng, family, interp, iq):
    p = _family_params(family, interp)
    rf = _rf(rng, p, iq)
    _check(golden.das(rf, p), _kernel(rf, p, iq))


@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("family", ["forces", "hercules", "rca"])
def test_coherency_matches_golden(rng, family, iq):
    p = _family_params(family, coherency_weighting=True)
    rf = _rf(rng, p, iq)
    ref = golden.das(rf, p)
    out = _kernel(rf, p, iq)
    assert isinstance(out, tuple) and len(out) == 2
    _check(ref, out)


def test_uforces_sparse(rng):
    p = _params(8, 5, 256, (12, 16, 1), AcquisitionKind.UFORCES, sparse=True,
                sparse_elements=np.array([0, 2, 4, 6, 7], np.int16),
                interpolation_mode=InterpolationMode.Linear)
    rf = _rf(rng, p, False)
    _check(golden.das(rf, p), _kernel(rf, p, False))


def test_uhercules_sparse(rng):
    p = _params(8, 5, 256, (8, 8, 12), AcquisitionKind.UHERCULES, sparse=True,
                sparse_elements=np.array([0, 2, 4, 6, 7], np.int16),
                transmit_receive_orientation=ROWS_COLS,
                transmit_angle=0.0, focus_depth=np.inf,
                interpolation_mode=InterpolationMode.Linear)
    rf = _rf(rng, p, False)
    _check(golden.das(rf, p), _kernel(rf, p, False))


def test_hercules_focused_swapped(rng):
    """Cylindrical transmit focus with rows and columns swapped."""
    p = _params(8, 4, 256, (8, 8, 12), AcquisitionKind.HERCULES,
                transmit_receive_orientation=pack_tx_rx_orientation(
                    RCAOrientation.Columns, RCAOrientation.Rows),
                transmit_angle=3.0, focus_depth=0.008,
                interpolation_mode=InterpolationMode.Linear)
    rf = _rf(rng, p, True)
    _check(golden.das(rf, p), _kernel(rf, p, True))


def test_hero_pa_is_hercules(rng):
    """HERO-PA dispatches onto the HERCULES path (das.glsl:390)."""
    kw = dict(transmit_receive_orientation=ROWS_COLS, transmit_angle=3.0,
              focus_depth=np.inf, interpolation_mode=InterpolationMode.Linear)
    p = _params(8, 4, 256, (8, 8, 12), AcquisitionKind.HERO_PA, **kw)
    rf = _rf(rng, p, False)
    out = _kernel(rf, p, False)
    _check(golden.das(rf, p), out)
    p2 = _params(8, 4, 256, (8, 8, 12), AcquisitionKind.HERCULES, **kw)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(_kernel(rf, p2, False)))


@pytest.mark.parametrize("kind,focus,orient,iq", [
    (AcquisitionKind.Flash, np.inf, RCAOrientation.Columns, False),
    (AcquisitionKind.RCA_VLS, 0.008, RCAOrientation.Rows, True),
])
def test_rca_kinds(rng, kind, focus, orient, iq):
    out_points = (8, 8, 12) if orient == RCAOrientation.Rows else (12, 16, 1)
    p = _params(8, 3, 256, out_points, kind,
                interpolation_mode=InterpolationMode.Cubic,
                **_rca_kw(3, focus, orient))
    rf = _rf(rng, p, iq)
    _check(golden.das(rf, p), _kernel(rf, p, iq))


@pytest.mark.parametrize("out_points", [
    (32, 4, 1),        # x fills the lane width exactly, one row tile
    (33, 5, 1),        # one lane past a tile in x, partial row tile
    (64, 2, 1),        # two full x tiles
    (7, 3, 5),         # 3D, narrower than a tile in every axis
    (40, 9, 3),        # 3D, partial tiles in x and in rows
])
def test_tile_padding(rng, out_points):
    """Grids that fill, overrun or underfill the (32 x, TILE/32 rows)
    tiles: every voxel is written once and lanes outside stay out."""
    nx, ny, nz = out_points
    p = _params(8, 2, 256, out_points, AcquisitionKind.FORCES,
                interpolation_mode=InterpolationMode.Linear)
    if sum(d > 1 for d in out_points) < 3:
        p = dataclasses.replace(p, voxel_transform=das_transform_2d_xz(
            [0, 1e-3], [7 * PITCH, 8e-3]))
    rf = _rf(rng, p, False)
    out = np.asarray(_kernel(rf, p, False))
    assert out.shape == out_points
    _check(golden.das(rf, p), out)


@pytest.mark.parametrize("iq,interp", [
    (True, InterpolationMode.Cubic),
    (True, InterpolationMode.Linear),
    (False, InterpolationMode.Linear),
    (False, InterpolationMode.Nearest),
])
def test_frame_batch(rng, iq, interp):
    """frame_batch=B maps the kernel over a leading batch axis: each frame
    equals its single-frame run."""
    p = _family_params("forces", interp)
    B = 2
    rf = _rf(rng, p, iq, (B,))
    out = np.asarray(_kernel(rf, p, iq, frame_batch=B))
    assert out.shape == (B,) + tuple(p.output_points)
    for b in range(B):
        single = np.asarray(_kernel(rf[b], p, iq))
        assert np.abs(single).max() > 0
        assert nrmse(single, out[b]) < 1e-6


def test_frame_batch_coherency(rng):
    p = _family_params("hercules", coherency_weighting=True)
    rf = _rf(rng, p, False, (2,))
    coh, inco = _kernel(rf, p, False, frame_batch=2)
    for b in range(2):
        ref = golden.das(rf[b], p)
        _check(ref, (coh[b], inco[b]))


@pytest.mark.parametrize("family", ["forces", "hercules", "rca"])
def test_channel_shards_sum_to_frame(rng, family):
    """Two half-channel shards (``grid_channels`` + ``channel_offset``, as
    parallel/sharding.py runs them) sum to the full frame."""
    p = _family_params(family)
    rf = _rf(rng, p, True)
    half = p.channel_count // 2
    total = 0
    for k in range(2):
        dyn = dict(make_dynamic(p), channel_offset=jnp.int32(k * half))
        total = total + np.asarray(_kernel(rf[k * half:(k + 1) * half], p,
                                           True, dyn=dyn, grid_channels=half))
    _check(golden.das(rf, p), total)


def test_x_slabs_tile_the_frame(rng):
    """Two x-slabs (``global_points`` + ``x_offset``) concatenate to the
    full frame."""
    p = _family_params("forces")
    rf = _rf(rng, p, False)
    nx, ny, nz = p.output_points
    parts = []
    for k in range(2):
        dyn = dict(make_dynamic(p), x_offset=jnp.int32(k * nx // 2))
        parts.append(np.asarray(_kernel(
            rf, p, False, dyn=dyn, output_points=(nx // 2, ny, nz),
            global_points=(nx, ny, nz))))
    _check(golden.das(rf, p), np.concatenate(parts, axis=0))


@pytest.mark.parametrize("family", ["forces", "hercules", "rca"])
def test_kernel_matches_xla_path(rng, family):
    """Interpret-mode kernel against ops/das.py on the same input, cubic IQ
    with coherency, at chip_smoke.py's limit for this comparison (1e-4, a
    tenth of the golden contract): the two differ in summation order and
    in the last bits of the IQ phase argument (~400 rad here)."""
    p = _family_params(family, InterpolationMode.Cubic,
                       coherency_weighting=True)
    rf = _rf(rng, p, True)
    st = make_static(p, iq=True)
    ref = das(jnp.asarray(rf), make_dynamic(p), st)
    out = _kernel(rf, p, True)
    for r, o in zip(ref, out):
        assert np.abs(np.asarray(r)).max() > 0
        assert nrmse(np.asarray(r), np.asarray(o)) < 1e-4


def test_round_half_even_matches_jnp_round():
    x = jnp.asarray([-1.5, -0.5, 0.5, 1.5, 2.5, 2.4999, 2.5001, 3.0, 7.5],
                    jnp.float32)
    np.testing.assert_array_equal(np.asarray(das_gpu._round_half_even(x)),
                                  np.asarray(jnp.round(x)))


def test_readi_groups_are_not_supported(rng):
    """READI's Hadamard-weighted groups stay on ops/das.py."""
    p = _params(4, 4, 256, (8, 12, 1), AcquisitionKind.FORCES,
                readi_group_count=4, readi_group=2,
                das_hadamard=hadamard_transpose(4),
                interpolation_mode=InterpolationMode.Linear)
    st = make_static(p, iq=False)
    assert not das_gpu.supports(st)
    with pytest.raises(ValueError, match="READI"):
        das_gpu.das_gpu(jnp.zeros((4, 4, 256)), make_dynamic(p), st,
                        interpret=True)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided when the test runs)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the kernel compiles only for the card")


@pytest.mark.gpu
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("family", ["forces", "hercules", "rca"])
def test_compiled_kernel_matches_xla(gpu, rng, family, iq):
    """The kernel as compiled for the card against ops/das.py on the card:
    only the summation order differs."""
    p = _family_params(family, InterpolationMode.Cubic,
                       coherency_weighting=True)
    rf = jnp.asarray(_rf(rng, p, iq))
    st = make_static(p, iq=iq)
    ref = das(rf, make_dynamic(p), st)
    out = das_gpu.das_gpu(rf, make_dynamic(p), st)
    for r, o in zip(ref, out):
        assert nrmse(np.asarray(r), np.asarray(o)) < 1e-5
