"""Compute-plan builder: pipeline spec -> compiled XLA executable.

The analogue of the reference's compute-plan builder + shader
specialization (beamformer_core.c:412-831, vulkan.c:594-663): the graph of
stride/data-kind reshapes disappears (XLA owns layout), but the *plan*
survives as a pure function composed from the stage ops, traced once per
static descriptor and cached — mirroring the reference's
descriptor-hash-keyed pipeline cache (``cp->shader_hashes``,
beamformer_core.c:1035-1040).

Static (trace-time) vs traced split follows SURVEY.md §7: shapes, counts,
stage sequence, interpolation/decode modes are static; frequencies,
transforms, f-number, filter taps, Hadamard matrices are traced arrays so
parameter tweaks never recompile.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import das as das_ops
from ..ops import das_gpu
from ..ops.coherency import coherency_weighting
from ..ops.decode import decode_hadamard
from ..ops.filtering import demodulate, fir_filter, hilbert
from ..params.enums import (BeamformerError, DataKind, DecodeMode,
                            ErrorKind, ShaderKind)
from ..params.types import Parameters
from ..utils.filters import Filter
from ..utils.hadamard import hadamard
from ..utils.transforms import das_output_dimension
from .spec import PipelineSpec

@dataclass(frozen=True)
class StageDesc:
    """Static descriptor of one pipeline stage (the bake-parameter hash)."""

    kind: ShaderKind
    # Filter/Demodulate:
    filter_length: int = 0
    filter_complex: bool = False
    decimation_rate: int = 1
    # DAS:
    das: das_ops.DasStatic | None = None


@dataclass(frozen=True)
class PlanDescriptor:
    """Hashable key for the jit cache — everything that shapes the program."""

    stages: tuple[StageDesc, ...]
    data_kind: DataKind
    channel_count: int
    acquisition_count: int
    sample_count: int
    iq_pipeline: bool
    coherency_weighting: bool


@dataclass
class CompiledPlan:
    descriptor: PlanDescriptor
    fn: object                       # jitted (rf, dyn) -> frame | (coh, inco)
    dyn: dict                        # traced-parameter pytree
    output_points: tuple[int, int, int]
    iq: bool
    time_offset: float
    das_sample_count: int
    das_sampling_frequency: float

    def __call__(self, rf):
        return self.fn(rf, self.dyn)


def _plan_stages(parameters: Parameters, pipeline: PipelineSpec,
                 filters: dict[int, Filter]):
    """Walk the user pipeline mirroring the reference planner's prologue
    (beamformer_core.c:412-467): demodulation halves sample count and fs,
    filter delays accumulate into the DAS time offset, IQ-ness decides the
    DAS data kind."""
    stage_descs: list[StageDesc] = []
    sample_count = parameters.sample_count
    fs = float(parameters.sampling_frequency)
    time_offset = float(parameters.time_offset)
    decimation_rate = max(int(parameters.decimation_rate), 1)
    iq = pipeline.data_kind.is_complex

    run_hilbert = any(s.kind == ShaderKind.Hilbert for s in pipeline.stages)
    run_demodulate = any(s.kind == ShaderKind.Demodulate
                         for s in pipeline.stages)
    if run_demodulate:
        run_hilbert = False          # beamformer_core.c:426

    def get_filter(slot):
        if slot not in filters:
            raise BeamformerError(ErrorKind.InvalidFilterKind,
                                  f"filter slot {slot} not created")
        return filters[slot]

    for stage in pipeline.stages:
        kind = stage.kind
        if kind == ShaderKind.Decode:
            if parameters.decode_mode == DecodeMode.NoDecode:
                continue             # beamformer_core.c:487-489
            stage_descs.append(StageDesc(kind=ShaderKind.Decode))
        elif kind == ShaderKind.Demodulate:
            f = get_filter(stage.parameter)
            time_offset += f.time_delay
            stage_descs.append(StageDesc(
                kind=kind, filter_length=f.length, filter_complex=f.complex,
                decimation_rate=decimation_rate))
            sample_count = sample_count // 2 // decimation_rate
            fs = fs / 2.0 / decimation_rate
            iq = True
        elif kind == ShaderKind.Filter:
            f = get_filter(stage.parameter)
            time_offset += f.time_delay
            stage_descs.append(StageDesc(
                kind=kind, filter_length=f.length, filter_complex=f.complex))
        elif kind == ShaderKind.Hilbert:
            if not run_hilbert:
                continue
            stage_descs.append(StageDesc(kind=kind))
            iq = True
        elif kind == ShaderKind.DAS:
            pass                     # appended below with full static config
        elif kind in (ShaderKind.Sum, ShaderKind.MinMax):
            continue                 # dormant in reference planner (:491-496)
        else:
            continue
    return stage_descs, sample_count, fs, time_offset, iq


def resolve_das_backend(st: das_ops.DasStatic, backend: str = "auto") -> str:
    """"auto" runs the GPU kernel (ops/das_gpu.py) on a GPU for the
    families it implements, and ops/das.py otherwise: on other platforms,
    for READI's Hadamard-weighted groups and for kinds without a dispatch
    case (``das_gpu.supports``)."""
    if backend != "auto":
        return backend
    if jax.default_backend() == "gpu" and das_gpu.supports(st):
        return "pallas"
    return "xla"


def build_plan(parameters: Parameters, pipeline: PipelineSpec,
               filters: dict[int, Filter],
               channel_mapping=None, sparse_elements=None,
               focal_vectors=None, transmit_receive_orientations=None,
               voxel_block: int = 65536,
               das_backend: str = "auto",
               frame_batch: int = 1) -> CompiledPlan:
    """Build (or fetch from cache) the compiled pipeline for a parameter
    block's current state.

    ``frame_batch=B > 1`` builds a batched plan: call it with (B, ...)
    raw frames and get (B, ...) volumes from ONE device program (pre-DAS
    stages and DAS vmap over the batch) — the throughput mode for offline
    datasets and frame averaging."""
    from ..ops.golden import DasParams  # layout of DAS parameters

    stage_descs, sample_count, fs, time_offset, iq = _plan_stages(
        parameters, pipeline, filters)

    has_das = any(s.kind == ShaderKind.DAS for s in pipeline.stages)
    output_points = tuple(
        int(v) for v in das_output_dimension(parameters.output_points[:3]))

    das_static = None
    das_dyn = {}
    if has_das:
        # FORCES-family voxel transforms get the XDC transform premultiplied
        # (beamformer_core.c:757-763); the shader then works in XDC space.
        vt = np.asarray(parameters.das_voxel_transform, np.float32)
        kind = parameters.acquisition_kind
        if kind.name in ("FORCES", "UFORCES"):
            vt = np.asarray(parameters.xdc_transform, np.float32) @ vt

        readi = int(parameters.readi_group_count)
        dp = DasParams(
            acquisition_kind=kind,
            acquisition_count=parameters.acquisition_count,
            channel_count=parameters.channel_count,
            sample_count=sample_count,
            sampling_frequency=fs,
            demodulation_frequency=parameters.demodulation_frequency,
            speed_of_sound=parameters.speed_of_sound,
            time_offset=time_offset,
            interpolation_mode=parameters.interpolation_mode,
            f_number=parameters.f_number,
            voxel_transform=vt,
            xdc_transform=np.asarray(parameters.xdc_transform, np.float32),
            xdc_element_pitch=np.asarray(parameters.xdc_element_pitch,
                                         np.float32),
            output_points=output_points,
            single_orientation=bool(parameters.single_orientation),
            transmit_receive_orientation=int(
                parameters.transmit_receive_orientation),
            single_focus=bool(parameters.single_focus),
            transmit_angle=float(parameters.focal_vector[0]),
            focus_depth=float(parameters.focal_vector[1]),
            focal_vectors=focal_vectors,
            transmit_receive_orientations=transmit_receive_orientations,
            sparse=kind.sparse,
            sparse_elements=sparse_elements,
            readi_group_count=readi,
            readi_group=int(parameters.readi_group),
            das_hadamard=(np.asarray(
                hadamard(readi), np.float32).T if readi > 1 else None),
            coherency_weighting=bool(parameters.coherency_weighting),
        )
        das_static = dataclasses.replace(
            das_ops.make_static(dp, iq=iq, voxel_block=voxel_block),
            frame_batch=int(frame_batch))
        das_static = dataclasses.replace(
            das_static, backend=resolve_das_backend(das_static, das_backend))
        das_dyn = das_ops.make_dynamic(dp)
        stage_descs.append(StageDesc(kind=ShaderKind.DAS, das=das_static))

    desc = PlanDescriptor(
        stages=tuple(stage_descs),
        data_kind=pipeline.data_kind,
        channel_count=parameters.channel_count,
        acquisition_count=parameters.acquisition_count,
        sample_count=parameters.sample_count,
        iq_pipeline=iq,
        coherency_weighting=bool(parameters.coherency_weighting) and has_das,
    )

    # Traced-parameter pytree: taps per stage, Hadamard, DAS dynamics.
    dyn: dict = {"das": das_dyn}
    for i, sd in enumerate(stage_descs):
        if sd.kind in (ShaderKind.Filter, ShaderKind.Demodulate):
            f = filters[_stage_parameter(pipeline, sd.kind, i, stage_descs)]
            dyn[f"taps{i}"] = jnp.asarray(f.taps)
        elif sd.kind == ShaderKind.Decode:
            try:
                if parameters.decode_mode == DecodeMode.Walsh:
                    from ..utils.hadamard import walsh
                    h = walsh(parameters.acquisition_count)
                else:
                    h = hadamard(parameters.acquisition_count)
            except ValueError as e:
                raise BeamformerError(
                    ErrorKind.InvalidComputeStage,
                    f"Hadamard decode needs a supported order "
                    f"(2^k, 12*2^k, 20*2^k; Walsh: 2^k only): {e}")
            dyn[f"hadamard{i}"] = jnp.asarray(h, jnp.float32)
    dyn["sampling_frequency"] = jnp.float32(parameters.sampling_frequency)
    dyn["demodulation_frequency"] = jnp.float32(
        parameters.demodulation_frequency)

    fn = _compiled_fn(desc)
    return CompiledPlan(descriptor=desc, fn=fn, dyn=dyn,
                        output_points=output_points, iq=iq,
                        time_offset=time_offset,
                        das_sample_count=sample_count,
                        das_sampling_frequency=fs)


def _stage_parameter(pipeline: PipelineSpec, kind: ShaderKind, index,
                     stage_descs) -> int:
    """Recover the filter slot for the i-th planned stage of ``kind``.

    Planned stages preserve user order, so match the n-th occurrence.
    """
    occurrence = sum(1 for sd in stage_descs[:index] if sd.kind == kind)
    seen = 0
    for s in pipeline.stages:
        if s.kind == kind:
            if seen == occurrence:
                return s.parameter
            seen += 1
    raise KeyError(kind)


def compose_stages(desc: PlanDescriptor, rf, dyn, *,
                   skip_coherency_normalize: bool = False,
                   stage_key_offset: int = 0):
    """Pure stage composition for a static descriptor.  Shared by the
    single-chip jit (below) and the sharded pipeline (parallel/sharding.py),
    which defers coherency normalization until after the cross-device psum.

    When the DAS stage carries ``frame_batch == B > 1``, ``rf`` is
    (B, ...) raw frames: every stage maps over the batch inside one
    program.
    """
    fb = max((sd.das.frame_batch for sd in desc.stages
              if sd.das is not None), default=1)
    vm = jax.vmap if fb > 1 else (lambda f: f)
    x = rf
    if desc.data_kind.is_complex:
        # Interleaved scalar pairs -> complex64 (I, Q adjacent samples) for
        # all complex wire kinds: Int16Complex, Float32Complex,
        # Float16Complex (reference: shaders/reshape.glsl:30-82 pairs the
        # same way regardless of the scalar carrier).
        x = x.astype(jnp.float32)
        x = jax.lax.complex(x[..., 0::2], x[..., 1::2])
    out = None
    for i, sd in enumerate(desc.stages, start=stage_key_offset):
        if sd.kind == ShaderKind.Decode:
            x = vm(lambda y: decode_hadamard.__wrapped__(
                y, dyn[f"hadamard{i}"]))(x)
        elif sd.kind == ShaderKind.Demodulate:
            x = vm(lambda y: demodulate.__wrapped__(
                y, dyn[f"taps{i}"], dyn["demodulation_frequency"],
                dyn["sampling_frequency"], sd.decimation_rate,
                sd.filter_complex))(x)
        elif sd.kind == ShaderKind.Filter:
            x = vm(lambda y: fir_filter(y, dyn[f"taps{i}"], 1))(x)
        elif sd.kind == ShaderKind.Hilbert:
            x = vm(lambda y: hilbert.__wrapped__(y))(x)
        elif sd.kind == ShaderKind.DAS:
            out = das_ops.das(x, dyn["das"], sd.das)
    if out is None:
        return x                     # pre-DAS pipeline (e.g. decode only)
    if desc.coherency_weighting and not skip_coherency_normalize:
        coh, inco = out
        return coherency_weighting.__wrapped__(coh, inco, 1.0)
    return out


@lru_cache(maxsize=128)
def _compiled_fn(desc: PlanDescriptor):
    """Trace + jit the stage composition for a static descriptor."""
    return jax.jit(lambda rf, dyn: compose_stages(desc, rf, dyn))


@lru_cache(maxsize=32)
def compiled_stage_fns(desc: PlanDescriptor):
    """Individually-jitted per-stage callables for profile mode: the
    analogue of the reference's per-dispatch GPU timestamps
    (beamformer_core.c:1577-1628).  Each fn maps (x, dyn) -> x'; the last
    stage may return the frame tuple."""
    fns = []
    for i in range(len(desc.stages)):
        sub = dataclasses.replace(desc, stages=desc.stages[i:i + 1])

        def make(sub=sub, i=i, first=(i == 0)):
            def fn(x, dyn):
                # dyn keys (hadamard{i}/taps{i}) are indexed by the FULL
                # pipeline position, not the single-stage sub-descriptor's.
                if not first:
                    # input decoding (Int16Complex pairing) only applies to
                    # the raw first stage
                    sub2 = dataclasses.replace(sub,
                                               data_kind=DataKind.Float32)
                    return compose_stages(sub2, x, dyn, stage_key_offset=i)
                return compose_stages(sub, x, dyn, stage_key_offset=i)
            return jax.jit(fn)
        fns.append(make())
    return fns


def clear_plan_cache():
    _compiled_fn.cache_clear()
