"""Multi-chip execution: channel-axis sharding over a device mesh.

The reference is a single-GPU system; its scale axis is the 16-channel chunk
loop that re-runs the pre-DAS stages per chunk and accumulates DAS into the
frame (beamformer_core.c:1577-1587, das.glsl:406).  Here that same channel
axis becomes the distributed axis (SURVEY.md §2.2): every pre-DAS stage
(decode, filter/demodulate, Hilbert) is channel-wise independent, and the
DAS accumulation commutes with channel sharding — so each device runs the
full pipeline on its channel shard with *global* element indices (the
``channel_offset`` push-constant analogue, fed from ``axis_index``) and the
partial volumes are ``psum``-reduced (NCCL over NVLink on one host).

Coherency weighting is the one stage that must run *after* the global sum
(it divides accumulated coherent energy by accumulated incoherent energy),
so the sharded composition defers it until after the psum.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.coherency import coherency_weighting
from ..pipeline.plan import CompiledPlan, PlanDescriptor, compose_stages

CHANNEL_AXIS = "channels"


def make_mesh(devices=None, axis_name: str = CHANNEL_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices; the single axis is the
    channel axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


@lru_cache(maxsize=64)
def _sharded_fn(desc: PlanDescriptor, mesh: Mesh, axis_name: str):
    import dataclasses as _dc
    n = mesh.shape[axis_name]
    if desc.channel_count % n:
        raise ValueError(
            f"channel count {desc.channel_count} not divisible by "
            f"{n} devices")
    local_channels = desc.channel_count // n
    # Kernel grids iterate the *local* channel shard; element geometry keeps
    # the global channel count.
    stages = tuple(
        _dc.replace(sd, das=_dc.replace(sd.das, grid_channels=local_channels))
        if sd.das is not None else sd
        for sd in desc.stages)
    desc = _dc.replace(desc, stages=stages)

    def worker(rf_shard, dyn):
        # Global receive-element indices for this shard — the analogue
        # of the reference's channel_offset push constant (das.glsl:215).
        offset = jax.lax.axis_index(axis_name) * local_channels
        dyn = dict(dyn)
        if "das" in dyn and dyn["das"]:
            das_dyn = dict(dyn["das"])
            das_dyn["channel_offset"] = offset.astype(jnp.int32)
            dyn["das"] = das_dyn
        out = compose_stages(desc, rf_shard, dyn,
                             skip_coherency_normalize=True)
        # DAS accumulation commutes with channel sharding: all-reduce the
        # partial volume(s).
        return jax.tree.map(lambda v: jax.lax.psum(v, axis_name), out)

    # check_vma=False: scan carries inside the worker start device-invariant
    # and become device-varying after the first accumulation step, which the
    # strict varying-axis checker rejects; semantics are unaffected.
    mapped = jax.shard_map(
        worker, mesh=mesh,
        in_specs=(P(axis_name), P()),
        out_specs=P(),
        check_vma=False)

    def run(rf, dyn):
        out = mapped(rf, dyn)
        if desc.coherency_weighting:
            coh, inco = out
            return coherency_weighting.__wrapped__(coh, inco, 1.0)
        return out

    return jax.jit(run)


def shard_plan(plan: CompiledPlan, mesh: Mesh,
               axis_name: str = CHANNEL_AXIS) -> CompiledPlan:
    """Return a copy of ``plan`` whose fn runs channel-sharded over ``mesh``.

    The input RF array should be device_put with
    :func:`rf_sharding` for zero-copy dispatch; an unsharded host array also
    works (XLA will scatter it).
    """
    import dataclasses
    fn = _sharded_fn(plan.descriptor, mesh, axis_name)
    return dataclasses.replace(plan, fn=fn)


def rf_sharding(mesh: Mesh, axis_name: str = CHANNEL_AXIS) -> NamedSharding:
    """Sharding for the canonical (C, A, S) RF array: C split over devices."""
    return NamedSharding(mesh, P(axis_name, None, None))


def shard_rf(rf, mesh: Mesh, axis_name: str = CHANNEL_AXIS):
    return jax.device_put(rf, rf_sharding(mesh, axis_name))


SLAB_AXIS = "slabs"


def make_mesh_2d(channel_devices: int, slab_devices: int, devices=None,
                 channel_axis: str = CHANNEL_AXIS,
                 slab_axis: str = SLAB_AXIS) -> Mesh:
    """2D mesh: channel axis (psum-reduced DAS accumulation) x slab axis
    (independent voxel slabs of the output volume)."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices[: channel_devices * slab_devices])
    return Mesh(devices.reshape(channel_devices, slab_devices),
                (channel_axis, slab_axis))


@lru_cache(maxsize=32)
def _sharded_fn_2d(desc: PlanDescriptor, mesh: Mesh, channel_axis: str,
                   slab_axis: str):
    """Channel x slab sharding: each device beamforms its x-slab of the
    output from its channel shard; partial volumes psum over the channel
    axis (all-reduce), slabs concatenate without communication."""
    import dataclasses as _dc
    n_ch = mesh.shape[channel_axis]
    n_slab = mesh.shape[slab_axis]
    if desc.channel_count % n_ch:
        raise ValueError(f"channel count {desc.channel_count} not divisible "
                         f"by {n_ch} devices")
    local_channels = desc.channel_count // n_ch

    das_static = next(sd.das for sd in desc.stages if sd.das is not None)
    gnx, gny, gnz = das_static.output_points
    if gnx % n_slab:
        raise ValueError(f"output x extent {gnx} not divisible by "
                         f"{n_slab} slabs")
    nx_local = gnx // n_slab

    stages = tuple(
        _dc.replace(sd, das=_dc.replace(
            sd.das, grid_channels=local_channels,
            output_points=(nx_local, gny, gnz),
            global_points=(gnx, gny, gnz)))
        if sd.das is not None else sd
        for sd in desc.stages)
    local_desc = _dc.replace(desc, stages=stages)

    def worker(rf_shard, dyn):
        ch_offset = jax.lax.axis_index(channel_axis) * local_channels
        x_offset = jax.lax.axis_index(slab_axis) * nx_local
        dyn = dict(dyn)
        if "das" in dyn and dyn["das"]:
            das_dyn = dict(dyn["das"])
            das_dyn["channel_offset"] = ch_offset.astype(jnp.int32)
            das_dyn["x_offset"] = x_offset.astype(jnp.int32)
            dyn["das"] = das_dyn
        out = compose_stages(local_desc, rf_shard, dyn,
                             skip_coherency_normalize=True)
        return jax.tree.map(lambda v: jax.lax.psum(v, channel_axis), out)

    out_spec = (P(slab_axis), P(slab_axis)) if desc.coherency_weighting \
        else P(slab_axis)
    mapped = jax.shard_map(
        worker, mesh=mesh,
        in_specs=(P(channel_axis, None, None), P()),
        out_specs=out_spec,
        check_vma=False)

    def run(rf, dyn):
        out = mapped(rf, dyn)
        if desc.coherency_weighting:
            coh, inco = out
            return coherency_weighting.__wrapped__(coh, inco, 1.0)
        return out

    return jax.jit(run)


def shard_plan_2d(plan: CompiledPlan, mesh: Mesh,
                  channel_axis: str = CHANNEL_AXIS,
                  slab_axis: str = SLAB_AXIS) -> CompiledPlan:
    """Run the plan over a 2D (channels x slabs) mesh: DAS accumulation
    reduces over the channel axis while output x-slabs stay device-local —
    the scale-out shape for volumes larger than one chip's throughput."""
    import dataclasses
    fn = _sharded_fn_2d(plan.descriptor, mesh, channel_axis, slab_axis)
    return dataclasses.replace(plan, fn=fn)


def shard_rf_2d(rf, mesh: Mesh, channel_axis: str = CHANNEL_AXIS):
    return jax.device_put(
        rf, NamedSharding(mesh, P(channel_axis, None, None)))


# ---------------------------------------------------------------------------
# Transmit-axis sharding (multi-angle compounding)
# ---------------------------------------------------------------------------

TRANSMIT_AXIS = "transmits"


def make_mesh_tx(channel_devices: int, transmit_devices: int, devices=None,
                 channel_axis: str = CHANNEL_AXIS,
                 transmit_axis: str = TRANSMIT_AXIS) -> Mesh:
    """2D mesh: channels x transmits.  Both axes psum-reduce into the DAS
    volume; transmit sharding is the compounding analogue of data parallel
    (each device beamforms its subset of the steered transmits)."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices[: channel_devices * transmit_devices])
    return Mesh(devices.reshape(channel_devices, transmit_devices),
                (channel_axis, transmit_axis))


@lru_cache(maxsize=32)
def _sharded_fn_tx(desc: PlanDescriptor, mesh: Mesh, channel_axis: str,
                   transmit_axis: str):
    """Channels x transmits sharding for RCA compounding pipelines
    (TPW/VLS/Flash): every per-acquisition quantity lives in the traced
    tables (orientations, focal vectors), so each device runs the pipeline
    on its (channel, transmit) tile and the volume psum-reduces over both
    mesh axes.

    Decode pipelines are rejected: Hadamard decode contracts over the
    transmit axis, which would need an extra all-to-all — use the channel
    (and slab) axes for those.
    """
    import dataclasses as _dc
    from ..params.enums import ShaderKind
    if any(sd.kind == ShaderKind.Decode for sd in desc.stages):
        raise ValueError("transmit sharding requires a decode-free pipeline "
                         "(Hadamard decode contracts over transmits)")
    das_static = next(sd.das for sd in desc.stages if sd.das is not None)
    if das_static.family != "rca":
        raise ValueError("transmit sharding supports the RCA compounding "
                         "family (TPW/VLS/Flash)")

    n_ch = mesh.shape[channel_axis]
    n_tx = mesh.shape[transmit_axis]
    if desc.channel_count % n_ch:
        raise ValueError(f"channel count {desc.channel_count} not divisible "
                         f"by {n_ch}")
    if desc.acquisition_count % n_tx:
        raise ValueError(f"acquisition count {desc.acquisition_count} not "
                         f"divisible by {n_tx}")
    local_channels = desc.channel_count // n_ch
    local_acqs = desc.acquisition_count // n_tx

    stages = tuple(
        _dc.replace(sd, das=_dc.replace(sd.das,
                                        grid_channels=local_channels,
                                        acquisition_count=local_acqs))
        if sd.das is not None else sd
        for sd in desc.stages)
    local_desc = _dc.replace(desc, stages=stages,
                             acquisition_count=local_acqs)

    def worker(rf_shard, dyn):
        ch_offset = jax.lax.axis_index(channel_axis) * local_channels
        dyn = dict(dyn)
        if "das" in dyn and dyn["das"]:
            a_off = jax.lax.axis_index(transmit_axis) * local_acqs
            das_dyn = dict(dyn["das"])
            das_dyn["channel_offset"] = ch_offset.astype(jnp.int32)
            # per-acquisition tables: this shard's slice
            for k in ("focal_vectors", "orientations", "sparse_elements"):
                das_dyn[k] = jax.lax.dynamic_slice_in_dim(
                    das_dyn[k], a_off, local_acqs, axis=0)
            dyn["das"] = das_dyn
        out = compose_stages(local_desc, rf_shard, dyn,
                             skip_coherency_normalize=True)
        out = jax.tree.map(lambda v: jax.lax.psum(v, channel_axis), out)
        return jax.tree.map(lambda v: jax.lax.psum(v, transmit_axis), out)

    mapped = jax.shard_map(
        worker, mesh=mesh,
        in_specs=(P(channel_axis, transmit_axis, None), P()),
        out_specs=P(),
        check_vma=False)

    def run(rf, dyn):
        out = mapped(rf, dyn)
        if desc.coherency_weighting:
            coh, inco = out
            return coherency_weighting.__wrapped__(coh, inco, 1.0)
        return out

    return jax.jit(run)


def shard_plan_tx(plan: CompiledPlan, mesh: Mesh,
                  channel_axis: str = CHANNEL_AXIS,
                  transmit_axis: str = TRANSMIT_AXIS) -> CompiledPlan:
    """Run an RCA compounding plan over a channels x transmits mesh."""
    import dataclasses
    fn = _sharded_fn_tx(plan.descriptor, mesh, channel_axis, transmit_axis)
    return dataclasses.replace(plan, fn=fn)


def shard_rf_tx(rf, mesh: Mesh, channel_axis: str = CHANNEL_AXIS,
                transmit_axis: str = TRANSMIT_AXIS):
    return jax.device_put(
        rf, NamedSharding(mesh, P(channel_axis, transmit_axis, None)))
