"""Beamformer executor: parameter blocks, filter slots, frame backlog, stats.

The Python-native equivalent of the reference's app core + client library
pair: parameter blocks with region-granular dirty tracking
(beamformer_shared_memory.c:95-131), four filter slots per block
(beamformer_core.c:211-264), a frame-backlog ring with N-most-recent export
(beamformer.c:196-238, lib/ogl_beamformer_lib.c:655-702), and the exported
compute-timing stats table.  The shared-memory C shim (runtime/) drives this
same object for ABI clients.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..params.constants import (FILTER_SLOTS, MAX_CHANNEL_COUNT,
                                MAX_COMPUTE_SHADER_STAGES,
                                MAX_EMISSIONS_COUNT, MAX_PARAMETER_BLOCKS)
from ..params.enums import (BeamformerError, ContrastMode, DataKind,
                            ErrorKind, ShaderKind, ViewPlaneTag)
from ..params.types import (FilterParameters, LiveImagingParameters,
                            Parameters, SimpleParameters)
from ..runtime.upload import prepare_rf
from ..utils.filters import Filter, make_filter
from .plan import CompiledPlan, build_plan, compiled_stage_fns
from .spec import (PipelineSpec, validate_block, validate_parameters,
                   validate_pipeline)
from .stats import ComputeStats

# Host-clock passes over all stages when calibrating the stage split; the
# fastest pass of each stage counts.
_CALIBRATION_PASSES = 3


@partial(jax.jit, keep_unused=True)
def _dispatch_floor(x, dyn):
    """Takes a stage's arguments and does almost no work: its host-clock
    time is the dispatch and synchronisation cost that the clock adds to
    every stage, which on a GPU is as long as a small stage's own work."""
    return jnp.sum(jnp.ravel(x)[:8])


@dataclass
class Frame:
    """A beamformed frame (reference: BeamformerFrame)."""

    data: jax.Array                  # (nx, ny, nz) f32 or c64
    id: int
    view_plane: ViewPlaneTag = ViewPlaneTag.XZ

    @property
    def output_points(self):
        return self.data.shape

    @property
    def complex(self) -> bool:
        return bool(jnp.iscomplexobj(self.data))

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.data)

    def to_reference_layout(self) -> np.ndarray:
        """Flatten x-fastest as the reference exports frames
        (das.glsl:130-134): linear index = x + nx*y + nx*ny*z."""
        return self.to_numpy().transpose(2, 1, 0).ravel()


@dataclass
class ParameterBlock:
    """One of up to 16 parameter blocks (beamformer_shared_memory.c:95-131)."""

    parameters: Parameters = field(default_factory=Parameters)
    pipeline: PipelineSpec = field(default_factory=PipelineSpec)
    channel_mapping: np.ndarray = field(
        default_factory=lambda: np.arange(MAX_CHANNEL_COUNT, dtype=np.int16))
    sparse_elements: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_EMISSIONS_COUNT, np.int16))
    focal_vectors: np.ndarray = field(
        default_factory=lambda: np.zeros((MAX_EMISSIONS_COUNT, 2), np.float32))
    transmit_receive_orientations: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_EMISSIONS_COUNT, np.uint8))
    filters: dict[int, Filter] = field(default_factory=dict)
    dirty: bool = True
    _plan: CompiledPlan | None = None
    _batched_plans: dict = field(default_factory=dict)   # frame_batch -> plan

    def mark_dirty(self):
        self.dirty = True


class Beamformer:
    """A beamforming session: the user-facing API of the framework.

    Method names follow the client library's exported surface
    (lib/ogl_beamformer_lib_base.h:37-173) minus the ``beamformer_`` prefix;
    each ``*_at`` variant of the reference maps to the ``block=`` keyword.
    """

    def __init__(self, backlog_bytes: int = 1 << 30, voxel_block: int = 65536,
                 profile: bool = False, mesh=None):
        """``profile=True`` dispatches pipeline stages as separate programs
        and records per-stage wall-clock times into the stats table (at the
        cost of inter-stage fusion).  ``mesh``: a ``jax.sharding.Mesh`` to
        run channel-sharded across devices (parallel/sharding.py); the
        channel count must divide the mesh size."""
        self._blocks: list[ParameterBlock] = [ParameterBlock()]
        self._reserved = 1
        self._backlog: list[Frame] = []
        self._backlog_bytes = backlog_bytes
        self._frame_id = 0
        self._voxel_block = voxel_block
        self.profile = profile
        self.mesh = mesh
        self.stats = ComputeStats()
        self.live_parameters = LiveImagingParameters()
        self._live_dirty = 0
        self._stop_latch = False
        # Guards frame-id allocation, the backlog and the stats table:
        # pipelined sessions (one per parameter block) record frames from
        # concurrent worker threads.
        self._frame_lock = threading.RLock()
        # Number of stage-time calibrations run (one per plan rebuild);
        # exposed so tests can assert traced-parameter edits re-calibrate.
        self.calibration_count = 0
        # Sampled per-dispatch re-timing: every N computed frames the next
        # frame re-runs the per-stage calibration, so exported stage times
        # track device-side drift (clocks, thermals) in long runs —
        # the fused analogue of the reference re-timing every dispatch
        # (beamformer_core.c:1602-1628) at ~1/N overhead.  0 disables.
        self.recalibrate_every = 256
        self._frames_since_calibration = 0

    # ------------------------------------------------------------------
    # Parameter configuration
    # ------------------------------------------------------------------

    def reserve_parameter_blocks(self, count: int):
        """lib/ogl_beamformer_lib.c:239-251."""
        if count > MAX_PARAMETER_BLOCKS:
            raise BeamformerError(ErrorKind.ParameterBlockOverflow, str(count))
        while len(self._blocks) < count:
            self._blocks.append(ParameterBlock())
        self._reserved = max(count, 1)

    def _block(self, block: int) -> ParameterBlock:
        validate_block(block)
        if block >= self._reserved:
            raise BeamformerError(ErrorKind.ParameterBlockUnallocated,
                                  str(block))
        return self._blocks[block]

    def push_parameters(self, parameters: Parameters, block: int = 0):
        validate_parameters(parameters)
        b = self._block(block)
        b.parameters = parameters.copy()
        b.mark_dirty()

    def push_pipeline(self, shaders, data_kind, stage_parameters=None,
                      block: int = 0):
        validate_pipeline(shaders, data_kind)
        b = self._block(block)
        b.pipeline = PipelineSpec.from_shaders(shaders, data_kind,
                                               stage_parameters)
        b.mark_dirty()

    def set_pipeline_stage_parameters(self, stage_index: int, parameter: int,
                                      block: int = 0):
        b = self._block(block)
        if stage_index >= len(b.pipeline.stages):
            raise BeamformerError(ErrorKind.ComputeStageOverflow,
                                  str(stage_index))
        stages = list(b.pipeline.stages)
        stages[stage_index] = type(stages[stage_index])(
            kind=stages[stage_index].kind, parameter=parameter)
        b.pipeline = PipelineSpec(stages=tuple(stages),
                                  data_kind=b.pipeline.data_kind)
        b.mark_dirty()

    def push_channel_mapping(self, mapping, block: int = 0):
        b = self._block(block)
        m = np.asarray(mapping, np.int16)
        b.channel_mapping[:len(m)] = m

    def push_sparse_elements(self, elements, block: int = 0):
        b = self._block(block)
        e = np.asarray(elements, np.int16)
        b.sparse_elements[:len(e)] = e
        b.mark_dirty()

    def push_focal_vectors(self, vectors, block: int = 0):
        """``vectors``: (N, 2) interleaved (angle_degrees, focal_depth)."""
        b = self._block(block)
        v = np.asarray(vectors, np.float32).reshape(-1, 2)
        b.focal_vectors[:len(v)] = v
        b.mark_dirty()

    def push_transmit_receive_orientations(self, values, block: int = 0):
        b = self._block(block)
        v = np.asarray(values, np.uint8)
        b.transmit_receive_orientations[:len(v)] = v
        b.mark_dirty()

    def create_filter(self, filter_parameters: FilterParameters,
                      filter_slot: int, block: int = 0):
        """lib/ogl_beamformer_lib.c beamformer_create_filter."""
        if not (0 <= filter_slot < FILTER_SLOTS):
            raise BeamformerError(ErrorKind.InvalidFilterKind,
                                  f"slot {filter_slot}")
        b = self._block(block)
        b.filters[filter_slot] = make_filter(filter_parameters)
        b.mark_dirty()

    # ------------------------------------------------------------------
    # Compute
    # ------------------------------------------------------------------

    def _ensure_plan(self, b: ParameterBlock) -> CompiledPlan:
        """Rebuild the compiled plan if the block is dirty — the analogue of
        beamformer_commit_parameter_block (beamformer_core.c:1008-1120); the
        jit cache keyed on the static descriptor makes unchanged-shape
        rebuilds cheap."""
        if b.dirty or b._plan is None:
            if not b.pipeline.stages:
                raise BeamformerError(ErrorKind.InvalidStartShader,
                                      "no pipeline pushed")
            b._batched_plans.clear()
            a = b.parameters.acquisition_count
            b._plan = build_plan(
                b.parameters, b.pipeline, b.filters,
                channel_mapping=b.channel_mapping,
                sparse_elements=b.sparse_elements[:max(a, 1)],
                focal_vectors=b.focal_vectors[:max(a, 1)],
                transmit_receive_orientations=(
                    b.transmit_receive_orientations[:max(a, 1)]),
                voxel_block=self._voxel_block)
            if self.mesh is not None:
                from ..parallel.sharding import shard_plan
                b._plan = shard_plan(b._plan, self.mesh)
            self.stats.set_stages([sd.kind for sd in b._plan.descriptor.stages])
            b.dirty = False
        return b._plan

    def _stage_fractions(self, plan: CompiledPlan, rf) -> list[float]:
        """Per-stage share of frame time, calibrated once per *plan* by
        running each stage's individually-jitted fn and keeping the fastest
        of a few host-clock passes, each stage ending in
        ``block_until_ready``, less the time of a call that does no work on
        the same arguments.  This runs on the live path (parameter pushes,
        sampled re-timing, the streaming dispatch thread), so it opens no
        profiler session: a device trace stalls the stream and cannot nest
        inside a user's own ``jax.profiler`` trace.  Device times are the
        explicit :meth:`profile_device_stages`.  Cached on the
        CompiledPlan object, NOT the descriptor:
        traced values (f-number, speed of sound, transforms) change stage
        cost without changing the descriptor, and any parameter push
        rebuilds the plan — so every traced edit re-calibrates, the fused
        analogue of the reference re-timing each dispatch
        (beamformer_core.c:1602-1628)."""
        cached = getattr(plan, "_stage_fraction_cache", None)
        if cached is not None and not (
                self.recalibrate_every
                and self._frames_since_calibration >= self.recalibrate_every):
            return cached
        self._frames_since_calibration = 0
        self.calibration_count += 1
        fns = compiled_stage_fns(plan.descriptor)
        # interleaving the stages keeps one stretch of contention (or a
        # first-call compile) from landing on a single stage's runs
        runs = [[] for _ in fns]
        floors = [[] for _ in fns]
        for _ in range(_CALIBRATION_PASSES):
            out = jax.block_until_ready(jax.device_put(rf))
            for stage_runs, stage_floors, fn in zip(runs, floors, fns):
                t0 = time.perf_counter()
                jax.block_until_ready(_dispatch_floor(out, plan.dyn))
                t1 = time.perf_counter()
                out = jax.block_until_ready(fn(out, plan.dyn))
                stage_floors.append(t1 - t0)
                stage_runs.append(time.perf_counter() - t1)
        times = [max(min(r) - min(f), 1e-9) for r, f in zip(runs, floors)]
        total = sum(times)
        fractions = [t / total for t in times]
        plan._stage_fraction_cache = fractions
        return fractions

    def profile_device_stages(self, rf: np.ndarray, block: int = 0,
                              record: bool = False):
        """True per-stage DEVICE times from ``jax.profiler`` traces — the
        exact analogue of the reference bracketing every dispatch with GPU
        timestamps (vulkan.c:2616-2637, beamformer_core.c:1602-1628).

        Each stage's individually-jitted fn is traced in its own window
        (compile excluded by a warmup call) and its device busy time read
        from the trace (``utils/profiling.py``).

        ``rf``: canonical (C, A, S_wire) data.  Returns a list of
        ``(ShaderKind, device_seconds)``.  ``record=True`` also inserts
        the times into the stats table as one frame.  Requires a GPU: on
        other platforms the trace has no device plane and this raises
        (use ``profile=True`` wall-clock timing there)."""
        from ..utils.profiling import device_time
        b = self._block(block)
        plan = self._ensure_plan(b)
        times = []
        # on the device first, so the first stage's time holds no upload
        out = jax.block_until_ready(jax.device_put(np.asarray(rf)))
        for sd, fn in zip(plan.descriptor.stages,
                          compiled_stage_fns(plan.descriptor)):
            prof = device_time(fn, out, plan.dyn)
            times.append((sd.kind, prof.busy_seconds))
            out = fn(out, plan.dyn)
        if record:
            with self._frame_lock:
                self.stats.record_frame([t for _, t in times])
        return times

    def push_data_with_compute(self, data: np.ndarray,
                               image_plane_tag: int = 0,
                               block: int = 0) -> Frame:
        """Upload one raw frame and run the block's pipeline on it.

        ``data``: raw scanner layout (raw_channels, raw_samples) — channel
        mapping and contrast reduction are applied host-side exactly as the
        reference client does (lib/ogl_beamformer_lib.c:491-570).
        """
        if not (0 <= image_plane_tag < len(ViewPlaneTag)):
            raise BeamformerError(ErrorKind.InvalidImagePlane,
                                  str(image_plane_tag))
        b = self._block(block)
        p = b.parameters
        rf = prepare_rf(np.asarray(data), b.channel_mapping,
                        p.channel_count, p.acquisition_count, p.sample_count,
                        ContrastMode(p.contrast_mode), b.pipeline.data_kind)
        self.stats.record_rf_upload()
        return self._compute(rf, image_plane_tag, block)

    def compute_prepared(self, rf: np.ndarray, image_plane_tag: int = 0,
                         block: int = 0) -> Frame:
        """Run the pipeline on already-canonical (C, A, S_wire) data."""
        return self._compute(np.asarray(rf), image_plane_tag, block)

    def push_batch(self, data: np.ndarray, image_plane_tag: int = 0,
                   block: int = 0) -> list[Frame]:
        """Upload B raw frames and beamform them in ONE device program.

        ``data``: (B, raw_channels, raw_samples) raw scanner layout (same
        per-frame layout as :meth:`push_data_with_compute`).  The batched
        plan runs all B frames in one device program; use it for offline
        datasets and frame averaging (the reference's sum.glsl /
        output_points.w analogue).  Returns one :class:`Frame` per
        input frame (all recorded in the backlog).  Unsupported together
        with a device mesh (shard the channel axis or batch, not both)."""
        if not (0 <= image_plane_tag < len(ViewPlaneTag)):
            raise BeamformerError(ErrorKind.InvalidImagePlane,
                                  str(image_plane_tag))
        if self.mesh is not None:
            raise BeamformerError(ErrorKind.InvalidComputeStage,
                                  "push_batch with a device mesh")
        data = np.asarray(data)
        if data.ndim != 3:
            raise BeamformerError(ErrorKind.DataSizeMismatch,
                                  f"expected (B, raw_channels, raw_samples),"
                                  f" got {data.shape}")
        batch = data.shape[0]
        b = self._block(block)
        self._ensure_plan(b)                     # commit dirty state first
        plan = b._batched_plans.get(batch)
        if plan is None:
            a = b.parameters.acquisition_count
            plan = build_plan(
                b.parameters, b.pipeline, b.filters,
                channel_mapping=b.channel_mapping,
                sparse_elements=b.sparse_elements[:max(a, 1)],
                focal_vectors=b.focal_vectors[:max(a, 1)],
                transmit_receive_orientations=(
                    b.transmit_receive_orientations[:max(a, 1)]),
                voxel_block=self._voxel_block,
                frame_batch=batch)
            b._batched_plans[batch] = plan
        p = b.parameters
        rf = np.stack([
            prepare_rf(data[i], b.channel_mapping, p.channel_count,
                       p.acquisition_count, p.sample_count,
                       ContrastMode(p.contrast_mode), b.pipeline.data_kind)
            for i in range(batch)])
        for _ in range(batch):
            self.stats.record_rf_upload()
        t0 = time.perf_counter()
        out = jax.block_until_ready(plan(rf))
        dt = (time.perf_counter() - t0) / batch
        fractions = self._stage_fractions(b._plan, rf[0])
        frames = []
        with self._frame_lock:
            for i in range(batch):
                self._frames_since_calibration += 1
                self.stats.record_frame([dt * f for f in fractions])
        for i in range(batch):
            frames.append(self._register_frame(
                out[i], ViewPlaneTag(image_plane_tag)))
        return frames

    def warmup(self, block: int = 0) -> Frame:
        """Compile (and cache) the block's current descriptor by running
        one zero frame through it.

        First compile of a new configuration can take seconds; calling this
        at service start — once per expected configuration — keeps real
        frames off the compile path.  The zero
        frame is computed but not counted in the RF-arrival stats.
        """
        b = self._block(block)
        p = b.parameters
        wire = b.pipeline.data_kind
        n = p.channel_count * p.acquisition_count * p.sample_count
        if wire.is_complex and wire.name == "Int16Complex":
            raw = np.zeros((p.channel_count, 2 * n // p.channel_count),
                           np.int16)
        else:
            dt = {"Int16": np.int16, "Float32": np.float32,
                  "Float16": np.float16}.get(wire.name.replace("Complex", ""),
                                             np.float32)
            mult = 2 if wire.is_complex else 1
            raw = np.zeros((p.channel_count, mult * n // p.channel_count), dt)
        return self.push_data_with_compute(raw, block=block)

    def _compute(self, rf, image_plane_tag, block) -> Frame:
        b = self._block(block)
        plan = self._ensure_plan(b)
        if self.mesh is not None:
            from ..parallel.sharding import shard_rf
            rf = shard_rf(np.asarray(rf), self.mesh)
        if self.profile:
            out = rf
            stage_times = []
            for fn in compiled_stage_fns(plan.descriptor):
                t0 = time.perf_counter()
                out = jax.block_until_ready(fn(out, plan.dyn))
                stage_times.append(time.perf_counter() - t0)
            if plan.descriptor.coherency_weighting:
                pass  # folded into the DAS stage fn
            self.stats.record_frame(stage_times)
        else:
            t0 = time.perf_counter()
            out = jax.block_until_ready(plan(rf))
            dt = time.perf_counter() - t0
            # Fused pipeline: attribute the measured frame time across
            # stages by calibrated fractions (each stage timed individually
            # once per plan) — stage times sum to the true frame time and
            # reflect real relative cost, the fused analogue of the
            # reference's per-dispatch timestamps
            # (beamformer_core.c:1602-1628).
            fractions = self._stage_fractions(plan, rf)
            with self._frame_lock:
                self._frames_since_calibration += 1
                self.stats.record_frame([dt * f for f in fractions])
        return self._register_frame(out, ViewPlaneTag(image_plane_tag))

    def _register_frame(self, out, view_plane) -> Frame:
        """Allocate a frame id and append to the backlog under the frame
        lock (streaming sessions call this from worker threads)."""
        with self._frame_lock:
            frame = Frame(data=out, id=self._frame_id,
                          view_plane=view_plane)
            self._frame_id += 1
            self._push_backlog(frame)
        return frame

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------

    def _push_backlog(self, frame: Frame):
        self._backlog.append(frame)
        total = 0
        keep: list[Frame] = []
        for f in reversed(self._backlog):
            total += f.data.size * f.data.dtype.itemsize
            if total > self._backlog_bytes and keep:
                break
            keep.append(f)
        self._backlog = list(reversed(keep))

    def get_last_frames(self, count: int = 1) -> list[Frame]:
        """N most recent frames, oldest -> newest
        (lib/ogl_beamformer_lib_base.h:89-103)."""
        return self._backlog[-count:]

    def averaged_frame(self, count: int | None = None, block: int = 0):
        """Average of the most recent frames (the reference's
        ``output_points.w`` frame-averaging display path, dormant Sum shader
        semantics sum.glsl / beamformer_core.c:1026).  ``count`` defaults to
        the block's ``output_points[3]`` (min 1)."""
        from ..ops.display import sum_frames
        if count is None:
            count = max(int(self._block(block).parameters.output_points[3]), 1)
        frames = self.get_last_frames(count)
        if not frames:
            raise BeamformerError(ErrorKind.ExportSpaceOverflow,
                                  "no frames in backlog")
        stack = jnp.stack([f.data for f in frames])
        return Frame(data=sum_frames(stack), id=frames[-1].id,
                     view_plane=frames[-1].view_plane)

    def compute_timings(self):
        """Exported stats table (lib/ogl_beamformer_lib.c:738-754)."""
        return self.stats.table

    # ------------------------------------------------------------------
    # Simple API
    # ------------------------------------------------------------------

    def beamform_data(self, simple: SimpleParameters,
                      data: np.ndarray) -> Frame:
        """One-shot: push parameters + pipeline + tables, run, return frame
        (lib/ogl_beamformer_lib.c:704-736 beamformer_beamform_data)."""
        shaders = [s for s in simple.compute_stages]
        validate_pipeline(shaders, simple.data_kind)
        self.push_parameters(simple.parameters)
        self.push_pipeline(shaders, simple.data_kind,
                          simple.compute_stage_parameters[:len(shaders)])
        self.push_channel_mapping(simple.channel_mapping)
        self.push_sparse_elements(simple.sparse_elements)
        self.push_focal_vectors(simple.focal_vectors)
        self.push_transmit_receive_orientations(
            simple.transmit_receive_orientations)
        return self.push_data_with_compute(data)

    # ------------------------------------------------------------------
    # Live imaging controls
    # ------------------------------------------------------------------

    def set_live_parameters(self, params: LiveImagingParameters,
                            dirty_flags: int = 0):
        from ..params.enums import LiveImagingDirtyFlags
        self.live_parameters = params
        self._live_dirty |= dirty_flags
        # Latch StopImaging so the control is not lost when a polling
        # client consumes the dirty flag before a session checks it.
        if dirty_flags & LiveImagingDirtyFlags.StopImaging \
                and not params.active:
            self._stop_latch = True
        elif params.active:
            self._stop_latch = False

    def get_live_parameters(self) -> LiveImagingParameters:
        return self.live_parameters

    def live_parameters_get_dirty_flag(self) -> int:
        """Returns and clears the accumulated dirty flags
        (lib/ogl_beamformer_lib.c:756-788)."""
        flags = self._live_dirty
        self._live_dirty = 0
        return flags
