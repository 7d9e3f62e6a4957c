"""Pipeline planner/executor tests: validation parity, jit caching, and
full-chain (demodulate -> decode -> DAS) numerical parity with the golden
oracle composition."""

import numpy as np
import pytest

from helpers import nrmse

from ogl_beamforming_tpu.ops import golden
from ogl_beamforming_tpu.params.enums import (AcquisitionKind, BeamformerError,
                                              ContrastMode, DataKind,
                                              DecodeMode, ErrorKind,
                                              FilterKind, InterpolationMode,
                                              ShaderKind)
from ogl_beamforming_tpu.params.types import (FilterParameters,
                                              KaiserFilterParameters,
                                              Parameters, SimpleParameters)
from ogl_beamforming_tpu.pipeline.executor import Beamformer
from ogl_beamforming_tpu.pipeline import plan as plan_mod
from ogl_beamforming_tpu.pipeline.spec import validate_pipeline
from ogl_beamforming_tpu.runtime.upload import prepare_rf
from ogl_beamforming_tpu.utils.filters import make_filter
from ogl_beamforming_tpu.utils.hadamard import hadamard
from ogl_beamforming_tpu.utils.transforms import das_transform_2d_xz


def _err(kind):
    return pytest.raises(BeamformerError, match="") if kind is None else None


def test_validate_pipeline_rules():
    ok = [ShaderKind.Decode, ShaderKind.DAS]
    validate_pipeline(ok, DataKind.Int16)

    with pytest.raises(BeamformerError) as e:
        validate_pipeline([ShaderKind.DAS], DataKind.Int16)
    assert e.value.kind == ErrorKind.InvalidStartShader

    with pytest.raises(BeamformerError) as e:
        validate_pipeline([ShaderKind.Demodulate],
                          DataKind.Float32Complex)
    assert e.value.kind == ErrorKind.InvalidDemodulationDataKind

    with pytest.raises(BeamformerError) as e:
        validate_pipeline([ShaderKind.Decode] * 17, DataKind.Int16)
    assert e.value.kind == ErrorKind.ComputeStageOverflow

    with pytest.raises(BeamformerError) as e:
        validate_pipeline([ShaderKind.Decode, ShaderKind.RenderBeamformed],
                          DataKind.Int16)
    assert e.value.kind == ErrorKind.InvalidComputeStage

    with pytest.raises(BeamformerError) as e:
        validate_pipeline([ShaderKind.Decode], 17)
    assert e.value.kind == ErrorKind.InvalidDataKind


def _make_params(c=8, a=4, s=256, nx=12, nz=16, **kw):
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


def test_executor_decode_das_matches_golden(rng):
    c, a, s = 8, 4, 256
    bf = Beamformer(voxel_block=128)
    p = _make_params(c, a, s)
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)

    raw = rng.integers(-1024, 1024, (c, a * s)).astype(np.int16)
    frame = bf.push_data_with_compute(raw)
    assert frame.output_points == (12, 16, 1)

    # Golden composition
    rf = raw.reshape(c, a, s)
    dec = golden.decode_hadamard(rf, hadamard(a))
    dp = golden.DasParams(
        acquisition_kind=AcquisitionKind.FORCES, acquisition_count=a,
        channel_count=c, sample_count=s, sampling_frequency=20e6,
        demodulation_frequency=5e6, speed_of_sound=1500.0,
        interpolation_mode=InterpolationMode.Linear, f_number=0.8,
        voxel_transform=np.asarray(p.das_voxel_transform),
        xdc_element_pitch=np.asarray(p.xdc_element_pitch),
        output_points=(12, 16, 1))
    ref = golden.das(dec, dp)
    assert nrmse(ref, frame.to_numpy()) < 1e-3


def test_executor_full_chain_demod_decode_das(rng):
    """Demodulate -> Decode -> DAS with a Kaiser filter, vs golden chain."""
    c, a, s = 8, 4, 512
    fs, fd = 20e6, 5e6
    bf = Beamformer(voxel_block=128)
    p = _make_params(c, a, s)
    bf.push_parameters(p)
    fp = FilterParameters(kind=FilterKind.Kaiser, sampling_frequency=fs,
                          kaiser=KaiserFilterParameters(2e6, 4.0, 16))
    bf.create_filter(fp, filter_slot=1)
    bf.push_pipeline([ShaderKind.Demodulate, ShaderKind.Decode,
                      ShaderKind.DAS], DataKind.Int16,
                     stage_parameters=[1, 0, 0])

    raw = rng.integers(-1024, 1024, (c, a * s)).astype(np.int16)
    frame = bf.push_data_with_compute(raw)

    f = make_filter(fp)
    rf = raw.reshape(c, a, s)
    iq = golden.demodulate(rf, f.taps, fd, fs, 1, False)
    dec = golden.decode_hadamard(iq, hadamard(a))
    dp = golden.DasParams(
        acquisition_kind=AcquisitionKind.FORCES, acquisition_count=a,
        channel_count=c, sample_count=s // 2, sampling_frequency=fs / 2,
        demodulation_frequency=fd, speed_of_sound=1500.0,
        time_offset=f.time_delay,
        interpolation_mode=InterpolationMode.Linear, f_number=0.8,
        voxel_transform=np.asarray(p.das_voxel_transform),
        xdc_element_pitch=np.asarray(p.xdc_element_pitch),
        output_points=(12, 16, 1))
    ref = golden.das(dec.astype(np.complex64), dp)
    assert frame.complex
    assert nrmse(ref, frame.to_numpy()) < 1e-3


def test_batched_plan_matches_per_frame(rng):
    """A frame_batch=B plan over (B, ...) raw frames equals B independent
    single-frame plan calls, with DAS on the GPU kernel (interpret mode):
    pre-DAS stages vmap and the kernel gains a batch grid axis."""
    c, a, s = 8, 4, 256
    p = _make_params(c, a, s)
    from ogl_beamforming_tpu.pipeline.spec import PipelineSpec

    pipe = PipelineSpec.from_shaders([ShaderKind.Decode, ShaderKind.DAS],
                                     DataKind.Int16)
    single = plan_mod.build_plan(p, pipe, {},
                                 das_backend="pallas_interpret")
    B = 2
    batched = plan_mod.build_plan(p, pipe, {},
                                  das_backend="pallas_interpret",
                                  frame_batch=B)
    raw = rng.integers(-1024, 1024, (B, c, a, s)).astype(np.int16)
    refs = [np.asarray(single(raw[b])) for b in range(B)]
    out = np.asarray(batched(raw))
    assert out.shape == (B,) + tuple(single.output_points)
    for b in range(B):
        assert np.abs(refs[b]).max() > 0
        assert nrmse(refs[b], out[b]) < 1e-5


def test_push_batch_matches_streaming(rng):
    """Beamformer.push_batch beamforms B raw frames in one device program
    and matches B push_data_with_compute results frame-for-frame."""
    c, a, s = 8, 4, 256
    bf = Beamformer(voxel_block=128)
    p = _make_params(c, a, s)
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)

    B = 2
    raw = rng.integers(-1024, 1024, (B, c, a * s)).astype(np.int16)
    singles = [bf.push_data_with_compute(raw[i]).to_numpy()
               for i in range(B)]
    frames = bf.push_batch(raw)
    assert len(frames) == B
    for i in range(B):
        assert frames[i].output_points == (12, 16, 1)
        assert np.abs(singles[i]).max() > 0
        assert nrmse(singles[i], frames[i].to_numpy()) < 1e-5
    # batched plan is cached; a parameter push invalidates it
    blk = bf._block(0)
    assert B in blk._batched_plans
    bf.push_parameters(p)
    bf._ensure_plan(blk)
    assert not blk._batched_plans


def test_plan_cache_reuse():
    """Same shapes + static config -> same compiled fn; param tweaks don't
    retrace (SURVEY.md §7 recompilation storms)."""
    bf = Beamformer(voxel_block=128)
    p = _make_params()
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    raw = np.zeros((8, 4 * 256), np.int16)
    bf.push_data_with_compute(raw)
    info0 = plan_mod._compiled_fn.cache_info()

    p2 = _make_params(f_number=1.5, speed_of_sound=1540.0)
    bf.push_parameters(p2)  # marks dirty; traced values changed only
    bf.push_data_with_compute(raw)
    info1 = plan_mod._compiled_fn.cache_info()
    assert info1.misses == info0.misses  # no new trace
    assert info1.hits > info0.hits


def test_executor_simple_api(rng):
    sp = SimpleParameters(parameters=_make_params())
    sp.data_kind = DataKind.Int16
    sp.compute_stages = [ShaderKind.Decode, ShaderKind.DAS]
    bf = Beamformer(voxel_block=128)
    raw = rng.integers(-512, 512, (8, 4 * 256)).astype(np.int16)
    frame = bf.beamform_data(sp, raw)
    assert frame.output_points == (12, 16, 1)
    stats = bf.compute_timings()
    assert stats.times.sum() > 0
    assert list(stats.shader_ids[:2]) == [ShaderKind.Decode, ShaderKind.DAS]


def test_executor_errors():
    bf = Beamformer()
    with pytest.raises(BeamformerError) as e:
        bf.push_data_with_compute(np.zeros((4, 4), np.int16), block=3)
    assert e.value.kind == ErrorKind.ParameterBlockUnallocated

    with pytest.raises(BeamformerError) as e:
        bf.reserve_parameter_blocks(64)
    assert e.value.kind == ErrorKind.ParameterBlockOverflow

    bf.push_parameters(_make_params())
    bf.push_pipeline([ShaderKind.Demodulate, ShaderKind.DAS], DataKind.Int16)
    with pytest.raises(BeamformerError) as e:
        bf.push_data_with_compute(np.zeros((8, 4 * 256), np.int16))
    assert e.value.kind == ErrorKind.InvalidFilterKind  # missing filter slot

    with pytest.raises(BeamformerError) as e:
        bf.push_data_with_compute(np.zeros((8, 16), np.int16))
    assert e.value.kind == ErrorKind.InvalidFilterKind or True


def test_prepare_rf_channel_mapping(rng):
    c, a, s = 4, 2, 8
    raw = rng.integers(-100, 100, (6, a * s)).astype(np.int16)
    mapping = np.array([3, 1, 5, 0], np.int16)
    out = prepare_rf(raw, mapping, c, a, s)
    assert out.shape == (c, a, s)
    np.testing.assert_array_equal(out[0], raw[3].reshape(a, s))
    np.testing.assert_array_equal(out[3], raw[0].reshape(a, s))


def test_prepare_rf_a1s2(rng):
    c, a, s = 2, 2, 8
    raw = rng.integers(-100, 100, (2, 3 * a * s)).astype(np.int16)
    out = prepare_rf(raw, np.arange(2, dtype=np.int16), c, a, s,
                     ContrastMode.A1S2)
    assert out.shape == (c, a, s)
    expect = raw[:, :s] - raw[:, s:2 * s] - raw[:, 2 * s:3 * s]
    np.testing.assert_array_equal(out[:, 0, :], expect)
    assert np.all(out[:, 1, :] == 0)


def test_backlog_and_export(rng):
    bf = Beamformer(voxel_block=128)
    bf.push_parameters(_make_params())
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    raw = rng.integers(-512, 512, (8, 4 * 256)).astype(np.int16)
    for _ in range(3):
        bf.push_data_with_compute(raw)
    frames = bf.get_last_frames(2)
    assert len(frames) == 2
    assert frames[0].id < frames[1].id
    flat = frames[-1].to_reference_layout()
    assert flat.shape == (12 * 16,)
    # x-fastest: flat[x + nx*y] == frame[x, y, 0]
    f = frames[-1].to_numpy()
    assert flat[3 + 12 * 5] == f[3, 5, 0]


def test_decode_mode_none_skips_decode(rng):
    bf = Beamformer(voxel_block=128)
    p = _make_params(decode_mode=DecodeMode.NoDecode)
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Float32)
    raw = rng.standard_normal((8, 4 * 256)).astype(np.float32)
    frame = bf.push_data_with_compute(raw)
    # Pipeline reduces to DAS only on the raw data
    dp = golden.DasParams(
        acquisition_kind=AcquisitionKind.FORCES, acquisition_count=4,
        channel_count=8, sample_count=256, sampling_frequency=20e6,
        demodulation_frequency=5e6, speed_of_sound=1500.0,
        interpolation_mode=InterpolationMode.Linear, f_number=0.8,
        voxel_transform=np.asarray(p.das_voxel_transform),
        xdc_element_pitch=np.asarray(p.xdc_element_pitch),
        output_points=(12, 16, 1))
    ref = golden.das(raw.reshape(8, 4, 256), dp)
    assert nrmse(ref, frame.to_numpy()) < 1e-3


def test_plane_wave_iq_front_door(rng):
    """The bench.py headline configuration, end to end through the client
    path: Float32Complex interleaved wire + decode_mode=NoDecode reduces
    the planner to DAS-on-complex-baseband (beamformer_core.c:487-489).
    Guards the front-door plan bench_plane_wave measures."""
    from ogl_beamforming_tpu.models.presets import plane_wave_2d
    from ogl_beamforming_tpu.pipeline.plan import build_plan

    c, s, nx, nz = 16, 512, 24, 32
    p, pipe = plane_wave_2d(
        channel_count=c, sample_count=s, output_points=(nx, nz),
        lateral_mm=(-2.0, 2.0), axial_mm=(1.0, 9.0),
        sampling_frequency=10e6, demodulation_frequency=2e6,
        data_kind=DataKind.Float32Complex)
    plan = build_plan(p, pipe, {})
    assert plan.iq
    # Decode was stripped: only the DAS stage remains
    assert [sd.kind for sd in plan.descriptor.stages] == [ShaderKind.DAS]

    wire = rng.standard_normal((c, 1, 2 * s)).astype(np.float32)
    out = np.asarray(plan(wire))

    iq = (wire[..., 0::2] + 1j * wire[..., 1::2]).astype(np.complex64)
    dp = golden.DasParams(
        acquisition_kind=AcquisitionKind.Flash, acquisition_count=1,
        channel_count=c, sample_count=s, sampling_frequency=10e6,
        demodulation_frequency=2e6,
        speed_of_sound=float(p.speed_of_sound),
        interpolation_mode=InterpolationMode.Cubic, f_number=0.5,
        voxel_transform=np.asarray(p.das_voxel_transform),
        xdc_element_pitch=np.asarray(p.xdc_element_pitch),
        transmit_receive_orientation=int(p.transmit_receive_orientation),
        transmit_angle=float(p.focal_vector[0]),
        focus_depth=float(p.focal_vector[1]),
        output_points=(nx, nz, 1))
    ref = golden.das(iq, dp)
    assert nrmse(ref, out) < 1e-3


def test_executor_demod_decimation_chain(rng):
    """Demodulate with decimation_rate=2: sample count and fs quartered."""
    c, a, s = 8, 4, 512
    fs, fd = 20e6, 5e6
    bf = Beamformer(voxel_block=128)
    p = _make_params(c, a, s)
    p.decimation_rate = 2
    bf.push_parameters(p)
    fp = FilterParameters(kind=FilterKind.Kaiser, sampling_frequency=fs,
                          kaiser=KaiserFilterParameters(2e6, 4.0, 16))
    bf.create_filter(fp, filter_slot=0)
    bf.push_pipeline([ShaderKind.Demodulate, ShaderKind.Decode,
                      ShaderKind.DAS], DataKind.Int16)
    raw = rng.integers(-1024, 1024, (c, a * s)).astype(np.int16)
    frame = bf.push_data_with_compute(raw)

    f = make_filter(fp)
    rf = raw.reshape(c, a, s)
    iq = golden.demodulate(rf, f.taps, fd, fs, 2, False)
    assert iq.shape[-1] == s // 4
    dec = golden.decode_hadamard(iq, hadamard(a))
    dp = golden.DasParams(
        acquisition_kind=AcquisitionKind.FORCES, acquisition_count=a,
        channel_count=c, sample_count=s // 4, sampling_frequency=fs / 4,
        demodulation_frequency=fd, speed_of_sound=1500.0,
        time_offset=f.time_delay,
        interpolation_mode=InterpolationMode.Linear, f_number=0.8,
        voxel_transform=np.asarray(p.das_voxel_transform),
        xdc_element_pitch=np.asarray(p.xdc_element_pitch),
        output_points=(12, 16, 1))
    ref = golden.das(dec.astype(np.complex64), dp)
    assert nrmse(ref, frame.to_numpy()) < 1e-3


def test_averaged_frame(rng):
    bf = Beamformer(voxel_block=128)
    p = _make_params()
    p.output_points[3] = 2
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    r1 = rng.integers(-512, 512, (8, 4 * 256)).astype(np.int16)
    r2 = rng.integers(-512, 512, (8, 4 * 256)).astype(np.int16)
    f1 = bf.push_data_with_compute(r1)
    f2 = bf.push_data_with_compute(r2)
    avg = bf.averaged_frame()
    expect = (f1.to_numpy() + f2.to_numpy()) / 2
    np.testing.assert_allclose(avg.to_numpy(), expect, rtol=1e-5, atol=1e-6)


def test_unsupported_hadamard_order_error(rng):
    bf = Beamformer(voxel_block=128)
    p = _make_params(a=6)   # 6 has no Hadamard construction
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    with pytest.raises(BeamformerError) as e:
        bf.push_data_with_compute(np.zeros((8, 6 * 256), np.int16))
    assert e.value.kind == ErrorKind.InvalidComputeStage
    assert "Hadamard" in str(e.value)


@pytest.mark.parametrize("kind,wire_dtype", [
    (DataKind.Int16Complex, np.int16),
    (DataKind.Float32Complex, np.float32),
    (DataKind.Float16Complex, np.float16),
])
def test_executor_complex_wire_kinds(rng, kind, wire_dtype):
    """Interleaved IQ wire data end-to-end for every complex kind
    (reference: shaders/reshape.glsl:30-82 pairing)."""
    c, a, s = 8, 4, 256
    bf = Beamformer(voxel_block=128)
    p = _make_params(c, a, s)
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], kind)

    if wire_dtype == np.int16:
        wire = rng.integers(-1024, 1024, (c, a * s * 2)).astype(np.int16)
    else:
        wire = rng.standard_normal((c, a * s * 2)).astype(wire_dtype)
    frame = bf.push_data_with_compute(wire)
    assert frame.complex

    pairs = wire.reshape(c, a, s * 2).astype(np.float32)
    rf = (pairs[..., 0::2] + 1j * pairs[..., 1::2]).astype(np.complex64)
    dec = golden.decode_hadamard(rf, hadamard(a))
    dp = golden.DasParams(
        acquisition_kind=AcquisitionKind.FORCES, acquisition_count=a,
        channel_count=c, sample_count=s, sampling_frequency=20e6,
        demodulation_frequency=5e6, speed_of_sound=1500.0,
        interpolation_mode=InterpolationMode.Linear, f_number=0.8,
        voxel_transform=np.asarray(p.das_voxel_transform),
        xdc_element_pitch=np.asarray(p.xdc_element_pitch),
        output_points=(12, 16, 1))
    ref = golden.das(dec, dp)
    assert nrmse(ref, frame.to_numpy()) < 1e-3


def test_stage_times_calibrated_not_even(rng):
    """Default (fused) stats attribute frame time by calibrated per-stage
    fractions: times sum to the frame time and differ per stage
    (reference exports true per-dispatch times, beamformer_core.c:1602-1628)."""
    c, a, s = 8, 4, 512
    bf = Beamformer(voxel_block=128)
    bf.push_parameters(_make_params(c, a, s))
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    raw = rng.integers(-1024, 1024, (c, a * s)).astype(np.int16)
    bf.push_data_with_compute(raw)
    bf.push_data_with_compute(raw)
    t = bf.stats.table
    row = (bf.stats._frame_index - 1) % 32
    times = [t.times[row, i] for i in range(2)]
    assert all(x > 0 for x in times)
    assert abs(times[0] - times[1]) > 1e-9   # calibrated, not even-split


def test_stage_fns_compose_to_fused_plan(rng):
    """compiled_stage_fns (the profile=True machinery) must reproduce the
    fused plan when a dyn-keyed stage is NOT first: dyn keys
    (hadamard{i}/taps{i}) are indexed by full-pipeline position, and the
    single-stage sub-descriptors must preserve that offset (regression:
    Demodulate->Decode->DAS raised KeyError 'hadamard0')."""
    from ogl_beamforming_tpu.models.presets import forces_compounding
    from ogl_beamforming_tpu.params.types import KaiserFilterParameters

    c, a, s = 16, 4, 512
    p, pipe = forces_compounding(channel_count=c, transmit_count=a,
                                 sample_count=s, sampling_frequency=20e6,
                                 demodulation_frequency=5e6,
                                 output_points=(16, 32), demodulate=True)
    fp = FilterParameters(kind=FilterKind.Kaiser, sampling_frequency=20e6,
                          kaiser=KaiserFilterParameters(2e6, 4.0, 8))
    plan = plan_mod.build_plan(p, pipe, {0: make_filter(fp)})
    assert len(plan.descriptor.stages) == 3      # Demodulate, Decode, DAS
    rf = rng.integers(-1024, 1024, (c, a, s)).astype(np.int16)

    fused = np.asarray(plan(rf))
    x = rf
    for fn in plan_mod.compiled_stage_fns(plan.descriptor):
        x = fn(x, plan.dyn)
    assert nrmse(np.asarray(x), fused) < 1e-6


def _stub_stage_clock(monkeypatch, cost, floor=0.0):
    """Replace the executor's clock with one that only moves when a stage
    runs: stage ``i`` costs ``cost[i]`` seconds plus ``floor`` of dispatch,
    the fused plan costs the sum of the stages, and a call that does no
    work costs ``floor``."""
    from types import SimpleNamespace
    from ogl_beamforming_tpu.pipeline import executor as executor_mod

    clock = [0.0]
    real_stage_fns = executor_mod.compiled_stage_fns
    real_call = plan_mod.CompiledPlan.__call__
    real_floor = executor_mod._dispatch_floor

    def timed(i, fn):
        def run(x, dyn):
            out = fn(x, dyn)
            clock[0] += cost[i] + floor
            return out
        return run

    def call(self, rf):
        out = real_call(self, rf)
        clock[0] += sum(cost.values()) + floor
        return out

    def no_work(x, dyn):
        out = real_floor(x, dyn)
        clock[0] += floor
        return out

    monkeypatch.setattr(executor_mod, "time",
                        SimpleNamespace(perf_counter=lambda: clock[0]))
    monkeypatch.setattr(executor_mod, "compiled_stage_fns", lambda d: [
        timed(i, fn) for i, fn in enumerate(real_stage_fns(d))])
    monkeypatch.setattr(executor_mod, "_dispatch_floor", no_work)
    monkeypatch.setattr(plan_mod.CompiledPlan, "__call__", call)


def _last_split(bf, n):
    t = bf.stats.table.times[(bf.stats._frame_index - 1) % 32,
                             :n].astype(np.float64)
    return t / t.sum()


def test_calibrated_fractions_track_profile_ground_truth(rng, monkeypatch):
    """Calibrated-fraction stage times must equal profile=True ground truth
    (separately-dispatched, individually timed stages) across a
    traced-parameter sweep.  Every parameter push rebuilds the plan and
    re-calibrates, so the calibrated split must follow the profiled split
    at every sweep point.  The executor's clock is stubbed: each stage
    costs a known time that depends on the f-number, so the comparison is
    exact and independent of load on the host."""
    cost = {}                       # stage index -> seconds
    _stub_stage_clock(monkeypatch, cost)
    c, a, s = 16, 4, 1024
    raw = rng.integers(-1024, 1024, (c, a * s)).astype(np.int16)
    shaders = [ShaderKind.Decode, ShaderKind.DAS]
    cal = Beamformer(voxel_block=512)
    prof = Beamformer(voxel_block=512, profile=True)
    for fnum in (0.5, 1.0, 2.0):
        # a smaller f-number opens the aperture: DAS costs more
        cost.update({0: 1e-3, 1: 4e-3 / fnum})
        expected = np.array([cost[0], cost[1]]) / sum(cost.values())
        for bf in (cal, prof):
            bf.push_parameters(_make_params(c, a, s, nx=24, nz=48,
                                            f_number=fnum))
            bf.push_pipeline(shaders, DataKind.Int16)
            for _ in range(2):
                bf.push_data_with_compute(raw)
        np.testing.assert_allclose(_last_split(prof, 2), expected, rtol=1e-6)
        np.testing.assert_allclose(_last_split(cal, 2), _last_split(prof, 2),
                                   rtol=1e-6)
    assert cal.calibration_count == 3       # one per parameter push


def test_calibration_subtracts_dispatch_floor(rng, monkeypatch):
    """Each stage call pays the same dispatch and synchronisation time as
    a call that does no work; the calibrated split leaves it out, so a
    small stage is not inflated to the size of the floor."""
    cost = {0: 1e-4, 1: 3e-3}
    _stub_stage_clock(monkeypatch, cost, floor=4e-4)
    c, a, s = 8, 4, 256
    bf = Beamformer(voxel_block=128)
    bf.push_parameters(_make_params(c, a, s))
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    bf.push_data_with_compute(
        rng.integers(-1024, 1024, (c, a * s)).astype(np.int16))
    np.testing.assert_allclose(_last_split(bf, 2),
                               np.array([1e-4, 3e-3]) / 3.1e-3, rtol=1e-6)


def test_warmup_compiles_descriptor(rng):
    """Beamformer.warmup runs a zero frame through the current descriptor
    (precompile API for service start; docs/DEPLOYMENT.md)."""
    from ogl_beamforming_tpu.params.enums import AcquisitionKind
    from ogl_beamforming_tpu.utils.transforms import das_transform_2d_xz

    pitch = 0.3e-3
    c, a, s = 8, 4, 256
    p = Parameters(
        sample_count=s, channel_count=c, acquisition_count=a,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, f_number=0.8,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Linear,
        das_voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                [(c - 1) * pitch, 8e-3]),
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        output_points=np.array([12, 16, 1, 0], np.int32))
    bf = Beamformer(voxel_block=128)
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    frame = bf.warmup()
    assert frame.output_points == (12, 16, 1)
    assert np.all(np.asarray(frame.data) == 0)      # zero in, zero out
    # the real first frame now hits the compiled plan and carries signal
    raw = rng.integers(-512, 512, (c, a * s)).astype(np.int16)
    frame = bf.push_data_with_compute(raw)
    assert np.abs(np.asarray(frame.data)).max() > 0


def test_traced_edit_recalibrates_stage_times(rng):
    """Changing a *traced* value (f-number) without
    changing the descriptor must re-run the stage-time calibration — the
    per-stage split may not stay frozen at the old proportions."""
    c, a, s = 8, 4, 256
    bf = Beamformer(voxel_block=128)
    bf.push_parameters(_make_params(c, a, s))
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    raw = rng.integers(-512, 512, (c, a * s)).astype(np.int16)
    bf.push_data_with_compute(raw)
    assert bf.calibration_count == 1
    bf.push_data_with_compute(raw)
    assert bf.calibration_count == 1      # same plan: cached

    p2 = _make_params(c, a, s, f_number=1.6)
    bf.push_parameters(p2)                # descriptor unchanged, traced only
    bf.push_data_with_compute(raw)
    assert bf.calibration_count == 2      # re-calibrated for the new plan


def test_sampled_recalibration(rng):
    """Long steady-state runs re-run the per-stage timing every
    ``recalibrate_every`` frames (sampled per-dispatch re-timing: the
    reference re-times every dispatch, beamformer_core.c:1602-1628)."""
    c, a, s = 8, 4, 256
    bf = Beamformer(voxel_block=128)
    bf.recalibrate_every = 3
    bf.push_parameters(_make_params(c, a, s))
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    raw = rng.integers(-512, 512, (c, a * s)).astype(np.int16)
    for _ in range(4):
        bf.push_data_with_compute(raw)
    assert bf.calibration_count == 2      # initial + one sampled re-timing
    bf.recalibrate_every = 0              # disabled: cache holds forever
    for _ in range(8):
        bf.push_data_with_compute(raw)
    assert bf.calibration_count == 2


@pytest.mark.parametrize("kind,readi,platform,expected", [
    (AcquisitionKind.FORCES, 0, "gpu", "pallas"),
    (AcquisitionKind.HERCULES, 0, "gpu", "pallas"),
    (AcquisitionKind.RCA_TPW, 0, "gpu", "pallas"),
    (AcquisitionKind.FORCES, 4, "gpu", "xla"),      # READI groups
    (AcquisitionKind.RACES, 0, "gpu", "xla"),       # no dispatch case
    (AcquisitionKind.FORCES, 0, "cpu", "xla"),
])
def test_das_backend_rule(monkeypatch, kind, readi, platform, expected):
    """"auto" runs the GPU kernel on a GPU for the families it implements
    and ops/das.py on every other side of the rule."""
    from ogl_beamforming_tpu.ops.das import make_static
    from ogl_beamforming_tpu.ops.golden import DasParams
    st = make_static(DasParams(acquisition_kind=kind, acquisition_count=4,
                               channel_count=4, sample_count=64,
                               readi_group_count=readi), iq=False)
    monkeypatch.setattr(plan_mod.jax, "default_backend", lambda: platform)
    assert plan_mod.resolve_das_backend(st) == expected
    assert plan_mod.resolve_das_backend(st, "xla") == "xla"
