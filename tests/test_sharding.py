"""Multi-device (virtual 8-device CPU mesh) channel-sharded execution parity."""

import jax
import numpy as np
import pytest

from helpers import nrmse

from ogl_beamforming_tpu.params.enums import (AcquisitionKind, DataKind,
                                              InterpolationMode, ShaderKind)
from ogl_beamforming_tpu.params.types import Parameters
from ogl_beamforming_tpu.pipeline.executor import Beamformer
from ogl_beamforming_tpu.pipeline.plan import build_plan
from ogl_beamforming_tpu.pipeline.spec import PipelineSpec
from ogl_beamforming_tpu.parallel.sharding import (make_mesh, shard_plan,
                                                   shard_rf)
from ogl_beamforming_tpu.utils.transforms import das_transform_2d_xz


def _params(c=16, a=4, s=256, nx=12, nz=16, **kw):
    pitch = 0.3e-3
    p = Parameters(
        sample_count=s, channel_count=c, acquisition_count=a,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, f_number=0.8,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Linear,
        das_voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                [(c - 1) * pitch, 8e-3]),
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        output_points=np.array([nx, nz, 1, 0], np.int32))
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _plan_for(p, shaders, data_kind, filters=None):
    return build_plan(p, PipelineSpec.from_shaders(shaders, data_kind),
                      filters or {}, voxel_block=128)


@pytest.mark.parametrize("coherency", [False, True])
def test_sharded_gpu_kernel_matches_single(rng, coherency):
    """The GPU DAS kernel (interpret mode) composes under shard_map: each
    device runs its channel shard with its global channel offset."""
    p = _params(coherency_weighting=coherency)
    plan = build_plan(p, PipelineSpec.from_shaders(
        [ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16), {},
        das_backend="pallas_interpret")
    rf = rng.integers(-1024, 1024, (16, 4, 256)).astype(np.int16)
    ref = np.asarray(plan(rf))
    mesh = make_mesh(jax.devices()[:4])
    out = np.asarray(shard_plan(plan, mesh)(shard_rf(rf, mesh)))
    assert np.abs(ref).max() > 0
    assert nrmse(ref, out) < 1e-5


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("coherency", [False, True])
def test_sharded_decode_das_matches_single(rng, coherency):
    p = _params(coherency_weighting=coherency)
    plan = _plan_for(p, [ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    rf = rng.integers(-1024, 1024, (16, 4, 256)).astype(np.int16)

    ref = np.asarray(plan(rf.reshape(16, -1).reshape(16, 4, 256)))

    mesh = make_mesh()
    splan = shard_plan(plan, mesh)
    rf_sharded = shard_rf(rf, mesh)
    out = np.asarray(splan(rf_sharded))
    assert nrmse(ref, out) < 1e-5


def test_sharded_rca_matches_single(rng):
    from ogl_beamforming_tpu.params.enums import (RCAOrientation,
                                                  pack_tx_rx_orientation)
    p = _params(acquisition_kind=AcquisitionKind.Flash,
                transmit_receive_orientation=pack_tx_rx_orientation(
                    RCAOrientation.Columns, RCAOrientation.Columns))
    p.focal_vector = np.array([0.0, np.inf], np.float32)
    plan = _plan_for(p, [ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    rf = rng.integers(-1024, 1024, (16, 4, 256)).astype(np.int16)
    ref = np.asarray(plan(rf))
    mesh = make_mesh()
    out = np.asarray(shard_plan(plan, mesh)(shard_rf(rf, mesh)))
    assert nrmse(ref, out) < 1e-5


def test_sharded_channel_count_must_divide():
    p = _params(channel_count=12)
    plan = _plan_for(p, [ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    with pytest.raises(ValueError, match="not divisible"):
        shard_plan(plan, make_mesh())


def test_executor_with_mesh(rng):
    """Beamformer session running channel-sharded over the mesh."""
    p = _params()
    raw = rng.integers(-1024, 1024, (16, 4 * 256)).astype(np.int16)

    bf1 = Beamformer(voxel_block=128)
    bf1.push_parameters(p)
    bf1.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    ref = bf1.push_data_with_compute(raw).to_numpy()

    bf8 = Beamformer(voxel_block=128, mesh=make_mesh())
    bf8.push_parameters(p)
    bf8.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    out = bf8.push_data_with_compute(raw).to_numpy()
    assert nrmse(ref, out) < 1e-5


def test_sharded_2d_mesh_matches_single(rng):
    """channels x slabs mesh: psum over channels, slab-local output."""
    from ogl_beamforming_tpu.parallel.sharding import (make_mesh_2d,
                                                       shard_plan_2d,
                                                       shard_rf_2d)
    p = _params(c=16, nx=16, nz=32)
    plan = _plan_for(p, [ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    rf = rng.integers(-1024, 1024, (16, 4, 256)).astype(np.int16)
    ref = np.asarray(plan(rf))

    mesh = make_mesh_2d(4, 2)
    out = np.asarray(shard_plan_2d(plan, mesh)(shard_rf_2d(rf, mesh)))
    assert out.shape == ref.shape
    assert nrmse(ref, out) < 1e-5


def test_sharded_2d_coherency(rng):
    from ogl_beamforming_tpu.parallel.sharding import (make_mesh_2d,
                                                       shard_plan_2d,
                                                       shard_rf_2d)
    p = _params(c=16, nx=16, nz=32, coherency_weighting=True)
    plan = _plan_for(p, [ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    rf = rng.integers(-1024, 1024, (16, 4, 256)).astype(np.int16)
    ref = np.asarray(plan(rf))
    mesh = make_mesh_2d(2, 4)
    out = np.asarray(shard_plan_2d(plan, mesh)(shard_rf_2d(rf, mesh)))
    assert nrmse(ref, out) < 1e-5


def test_sharded_tx_mesh_matches_single(rng):
    """channels x transmits mesh (multi-angle TPW compounding) parity."""
    from ogl_beamforming_tpu.parallel.sharding import (make_mesh_tx,
                                                       shard_plan_tx,
                                                       shard_rf_tx)
    a = 8
    angles = np.linspace(-8, 8, a).astype(np.float32)
    fv = np.stack([angles, np.full(a, np.inf, np.float32)], axis=1)
    p = _params(a=a, acquisition_kind=AcquisitionKind.RCA_TPW,
                decode_mode=0, single_focus=0, single_orientation=1)
    plan = _plan_for(p, [ShaderKind.DAS], DataKind.Float32)
    # rebuild with explicit per-acq focal vectors
    plan = build_plan(p, PipelineSpec.from_shaders([ShaderKind.DAS],
                                                   DataKind.Float32),
                      {}, focal_vectors=fv, voxel_block=128)
    rf = rng.standard_normal((16, a, 256)).astype(np.float32)
    ref = plan(rf)

    mesh = make_mesh_tx(2, 4)
    sharded = shard_plan_tx(plan, mesh)
    out = sharded.fn(shard_rf_tx(rf, mesh), plan.dyn)
    assert nrmse(np.asarray(ref), np.asarray(out)) < 1e-5


def test_sharded_tx_rejects_decode(rng):
    from ogl_beamforming_tpu.parallel.sharding import (make_mesh_tx,
                                                       shard_plan_tx)
    p = _params()
    plan = _plan_for(p, [ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    with pytest.raises(ValueError, match="decode-free"):
        shard_plan_tx(plan, make_mesh_tx(2, 4))
