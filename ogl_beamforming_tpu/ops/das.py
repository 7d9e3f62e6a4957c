"""Delay-and-sum (DAS) beamforming in plain JAX: the reference path.

A per-voxel gather over (channel, transmit) RF lines with fractional-delay
interpolation, F-number apodization, and accumulation — shaders/das.glsl in
the reference (SURVEY.md §7).

Voxels are processed in blocks; for every channel (or acquisition) scan
step the delay field of the whole block is computed vectorially and the RF
line is gathered with ``take_along_axis``.  Channel accumulation is a
``lax.scan`` (mirroring the reference's 16-channel chunk loop,
beamformer_core.c:1577-1587), which is also the sharding axis on a
multi-device mesh: each device scans its channel shard and the partial
volumes are ``psum``-reduced (see parallel/sharding.py).  This path runs on
every platform and is what the GPU kernel (``ops/das_gpu.py``) is tested
against; the planner picks between them (``pipeline/plan.py``).

Geometry/indexing math mirrors das.glsl line-for-line; see
``ops/golden.py`` for the scalar model these functions are tested against.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..params.enums import AcquisitionKind, InterpolationMode, RCAOrientation
from . import das_gpu
from .golden import DasParams

_TWO_PI = 2.0 * np.pi


@dataclasses.dataclass(frozen=True)
class DasStatic:
    """Trace-time (bake) parameters — the analogue of the reference's
    SPIR-V specialization constants (generated/beamformer.c:198-217).

    Everything here changes the compiled program; everything numeric that
    doesn't (frequencies, transforms, f-number...) is traced via
    :class:`DasDynamic` so parameter tweaks don't trigger recompiles
    (SURVEY.md §7 "recompilation storms").
    """

    acquisition_kind: AcquisitionKind
    acquisition_count: int
    channel_count: int
    sample_count: int
    interpolation_mode: InterpolationMode
    output_points: tuple[int, int, int]
    iq: bool
    sparse: bool = False
    readi_group_count: int = 0
    coherency_weighting: bool = False
    voxel_block: int = 16384
    """Voxels per block of the XLA path; bounds its (A, voxel_block)
    transient working set."""
    backend: str = "xla"
    """Kernel backend: "xla" (gather-based, runs everywhere), "pallas"
    (the GPU kernel, ops/das_gpu.py), "pallas_interpret" (that kernel in
    Pallas interpret mode, for tests on the CPU)."""
    global_points: tuple[int, int, int] | None = None
    """Full output grid when this kernel computes only a slab of it (voxel
    sharding, parallel/sharding.py): normalized voxel coordinates use these
    denominators while output_points stays the local slab shape."""
    grid_channels: int = 0
    """Kernel-grid channel count when != channel_count: the per-shard local
    channel count under channel-axis sharding (parallel/sharding.py) —
    channel_count stays global for element-geometry terms."""
    frame_batch: int = 1
    """Frames beamformed per device program (``rf``: (B, C, A, S)), for
    offline datasets and frame averaging (the reference's sum.glsl +
    output_points.w path)."""

    @property
    def family(self) -> str:
        return self.acquisition_kind.das_family

    @property
    def local_channels(self) -> int:
        return self.grid_channels or self.channel_count


def make_dynamic(p: DasParams) -> dict:
    """Build the traced-parameter pytree from a :class:`DasParams`."""
    a = p.acquisition_count
    if p.single_focus or p.focal_vectors is None:
        fv = np.broadcast_to(
            np.array([p.transmit_angle, p.focus_depth], np.float32), (a, 2))
    else:
        fv = np.asarray(p.focal_vectors[:a], np.float32)
    if p.single_orientation or p.transmit_receive_orientations is None:
        orient = np.full((a,), int(p.transmit_receive_orientation), np.int32)
    else:
        orient = np.asarray(p.transmit_receive_orientations[:a], np.int32)
    sparse = (np.asarray(p.sparse_elements[:a], np.int32)
              if p.sparse_elements is not None else np.zeros(a, np.int32))
    g = max(p.readi_group_count, 1)
    if p.das_hadamard is not None:
        hrow = np.asarray(p.das_hadamard, np.float32)[p.readi_group]
    else:
        hrow = np.ones(g, np.float32)
    return {
        "sampling_frequency": jnp.float32(p.sampling_frequency),
        "demodulation_frequency": jnp.float32(p.demodulation_frequency),
        "speed_of_sound": jnp.float32(p.speed_of_sound),
        "time_offset": jnp.float32(p.time_offset),
        "f_number": jnp.float32(p.f_number),
        "voxel_transform": jnp.asarray(p.voxel_transform, jnp.float32),
        "xdc_transform": jnp.asarray(p.xdc_transform, jnp.float32),
        "xdc_element_pitch": jnp.asarray(p.xdc_element_pitch, jnp.float32),
        "focal_vectors": jnp.asarray(fv, jnp.float32),
        "orientations": jnp.asarray(orient, jnp.int32),
        "sparse_elements": jnp.asarray(sparse, jnp.int32),
        "hadamard_row": jnp.asarray(hrow, jnp.float32),
        "channel_offset": jnp.int32(0),
        "x_offset": jnp.int32(0),
    }


def make_static(p: DasParams, iq: bool, voxel_block: int = 16384) -> DasStatic:
    return DasStatic(
        acquisition_kind=p.acquisition_kind,
        acquisition_count=p.acquisition_count,
        channel_count=p.channel_count,
        sample_count=p.sample_count,
        interpolation_mode=p.interpolation_mode,
        output_points=tuple(int(v) for v in p.output_points),
        iq=iq,
        sparse=bool(p.sparse),
        readi_group_count=int(p.readi_group_count),
        coherency_weighting=bool(p.coherency_weighting),
        voxel_block=voxel_block,
    )


# ---------------------------------------------------------------------------
# Shared machinery
# ---------------------------------------------------------------------------

def _world_points(st: DasStatic, dyn) -> jax.Array:
    """Normalized voxel grid -> world points, flattened (V, 3)
    (das.glsl:368-376).  With ``global_points`` set, this instance computes
    the slab starting at ``dyn["x_offset"]`` of the full grid."""
    nx, ny, nz = st.output_points
    gnx, gny, gnz = st.global_points or (nx, ny, nz)
    denom = jnp.maximum(jnp.array([gnx, gny, gnz], jnp.float32) - 1.0, 1.0)
    x_off = dyn.get("x_offset", jnp.int32(0)).astype(jnp.float32)
    gx = (jax.lax.broadcasted_iota(jnp.float32, (nx, ny, nz), 0)
          + x_off) / denom[0]
    gy = jax.lax.broadcasted_iota(jnp.float32, (nx, ny, nz), 1) / denom[1]
    gz = jax.lax.broadcasted_iota(jnp.float32, (nx, ny, nz), 2) / denom[2]
    p = jnp.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    return _apply_m4(dyn["voxel_transform"], p)


def _apply_m4(m: jax.Array, pts: jax.Array) -> jax.Array:
    # elementwise form: a (N,3)@(3,3) dot could run at reduced matmul
    # precision (TF32 on the GPU), corrupting world coordinates
    return jnp.stack(
        [m[i, 0] * pts[..., 0] + m[i, 1] * pts[..., 1]
         + m[i, 2] * pts[..., 2] + m[i, 3] for i in range(3)], axis=-1)


def _gather_lines(lines: jax.Array, idx: jax.Array) -> jax.Array:
    """Gather ``lines[i, idx[i, v]]`` -> (N, V).  ``idx`` int32, pre-clipped."""
    return jnp.take_along_axis(lines, idx, axis=-1)


def _interpolate(st: DasStatic, lines: jax.Array, index: jax.Array) -> jax.Array:
    """Fractional-delay interpolation (das.glsl:64-122).

    ``lines``: (N, S) real or complex; ``index``: (N, V) fractional sample
    positions.  Out-of-range indices produce 0 with the reference's exact
    validity windows.
    """
    s = st.sample_count
    mode = st.interpolation_mode
    if mode == InterpolationMode.Nearest:
        valid = (jnp.floor(index) >= 0) & (jnp.round(index) < s)
        idx = jnp.clip(jnp.round(index).astype(jnp.int32), 0, s - 1)
        val = _gather_lines(lines, idx)
        return jnp.where(valid, val, 0)
    if mode == InterpolationMode.Linear:
        k = jnp.floor(index)
        valid = (k >= 0) & (k < s - 1)
        kk = jnp.clip(k.astype(jnp.int32), 0, s - 2)
        t = (index - k).astype(jnp.float32)
        v0 = _gather_lines(lines, kk)
        v1 = _gather_lines(lines, kk + 1)
        return jnp.where(valid, (1 - t) * v0 + t * v1, 0)
    # Cubic Catmull-Rom (C_SPLINE = 0.5, das.glsl:49,64-95)
    k = jnp.floor(index)
    valid = (k > 0) & (k < s - 2)
    kk = jnp.clip(k.astype(jnp.int32), 1, s - 3)
    t = (index - k).astype(jnp.float32)
    p0 = _gather_lines(lines, kk - 1)
    p1 = _gather_lines(lines, kk)
    p2 = _gather_lines(lines, kk + 1)
    p3 = _gather_lines(lines, kk + 2)
    t1 = 0.5 * (p2 - p0)
    t2 = 0.5 * (p3 - p1)
    tt = t * t
    ttt = tt * t
    val = ((2 * ttt - 3 * tt + 1) * p1 + (-2 * ttt + 3 * tt) * p2
           + (ttt - 2 * tt + t) * t1 + (ttt - tt) * t2)
    return jnp.where(valid, val, 0)


def _sample_rf(st: DasStatic, dyn, lines: jax.Array, index: jax.Array):
    """Interpolate + IQ phase rotation (das.glsl:51-59,97-122)."""
    val = _interpolate(st, lines, index)
    if st.iq:
        arg = (_TWO_PI * dyn["demodulation_frequency"]
               * (index / dyn["sampling_frequency"]))
        val = val * jax.lax.complex(jnp.cos(arg), jnp.sin(arg))
    return val


def _apodize(arg: jax.Array) -> jax.Array:
    a = jnp.cos(jnp.pi * arg)
    return a * a


def _sample_index(dyn, distance: jax.Array) -> jax.Array:
    return ((distance / dyn["speed_of_sound"] + dyn["time_offset"])
            * dyn["sampling_frequency"])


def _accum_init(st: DasStatic, shape) -> jax.Array:
    dtype = jnp.complex64 if st.iq else jnp.float32
    return jnp.zeros(shape, dtype)


# ---------------------------------------------------------------------------
# FORCES / UFORCES (das.glsl:286-319)
# ---------------------------------------------------------------------------

def _forces_block(st: DasStatic, dyn, rf: jax.Array, world: jax.Array):
    """One voxel block, all channels x transmits.  ``world``: (V, 3) already
    in XDC space (the planner premultiplies the transform for FORCES,
    beamformer_core.c:760-763)."""
    x, y, z = world[:, 0], world[:, 1], world[:, 2]
    z2 = z * z
    px = dyn["xdc_element_pitch"][0]
    py = dyn["xdc_element_pitch"][1]
    ty = y - py * (st.channel_count / 2)
    t_yz2 = ty * ty + z2

    sparse = int(st.sparse)
    n_tx = st.acquisition_count - sparse
    if st.sparse:
        tx_ch = dyn["sparse_elements"][:n_tx].astype(jnp.float32)
    else:
        tx_ch = jnp.arange(sparse, st.acquisition_count, dtype=jnp.float32)

    # Transmit index field: (n_tx, V), shared across channels.
    tx_dx = x[None, :] - px * tx_ch[:, None]
    tx_index = (jnp.sqrt(t_yz2[None, :] + tx_dx * tx_dx)
                * (dyn["sampling_frequency"] / dyn["speed_of_sound"]))

    def chan_body(acc, inputs):
        out, inco = acc
        ch, rf_c = inputs                      # rf_c: (A, S)
        rx_dx = x - ch * px
        a_arg = jnp.abs(dyn["f_number"] * rx_dx / z)
        mask = a_arg < 0.5
        apod = _apodize(jnp.where(mask, a_arg, 0))
        rx_index = _sample_index(dyn, jnp.sqrt(rx_dx * rx_dx + z2))
        index = rx_index[None, :] + tx_index   # (n_tx, V)
        lines = rf_c[sparse:, :]               # acquisitions sparse..A-1
        vals = _sample_rf(st, dyn, lines, index)
        vals = jnp.where(mask[None, :], apod[None, :] * vals, 0)
        out = out + vals.sum(axis=0)
        if st.coherency_weighting:
            inco = inco + jnp.abs(vals).sum(axis=0)
        return (out, inco), None

    v = world.shape[0]
    init = (_accum_init(st, (v,)), jnp.zeros((v,), jnp.float32))
    chans = (dyn["channel_offset"].astype(jnp.float32)
             + jnp.arange(rf.shape[0], dtype=jnp.float32))
    (out, inco), _ = jax.lax.scan(chan_body, init, (chans, rf))
    return out, inco


# ---------------------------------------------------------------------------
# READI FORCES (das.glsl:321-366)
# ---------------------------------------------------------------------------

def _readi_forces_block(st: DasStatic, dyn, rf: jax.Array, world: jax.Array):
    x, y, z = world[:, 0], world[:, 1], world[:, 2]
    z2 = z * z
    px = dyn["xdc_element_pitch"][0]
    py = dyn["xdc_element_pitch"][1]
    ty = y - py * (st.channel_count / 2)
    t_yz2 = ty * ty + z2

    g = st.readi_group_count
    a = st.acquisition_count
    # Element e = group * A + event maps to rf acquisition ``event`` with
    # weight hadamard_row[group] (das.glsl:349-361).
    tx_el = jnp.arange(g * a, dtype=jnp.float32)
    weights = jnp.repeat(dyn["hadamard_row"][:g], a)     # (G*A,)
    events = jnp.tile(jnp.arange(a, dtype=jnp.int32), g)  # (G*A,)

    tx_dx = x[None, :] - px * tx_el[:, None]
    tx_index = (jnp.sqrt(t_yz2[None, :] + tx_dx * tx_dx)
                * (dyn["sampling_frequency"] / dyn["speed_of_sound"]))

    def chan_body(acc, inputs):
        out, inco = acc
        ch, rf_c = inputs
        rx_dx = x - ch * px
        a_arg = jnp.abs(dyn["f_number"] * rx_dx / z)
        mask = a_arg < 0.5
        apod = _apodize(jnp.where(mask, a_arg, 0))
        rx_index = _sample_index(dyn, jnp.sqrt(rx_dx * rx_dx + z2))
        index = rx_index[None, :] + tx_index               # (G*A, V)
        lines = jnp.take(rf_c, events, axis=0)             # (G*A, S)
        vals = _sample_rf(st, dyn, lines, index)
        vals = jnp.where(mask[None, :],
                         (apod[None, :] * weights[:, None]) * vals, 0)
        out = out + vals.sum(axis=0)
        if st.coherency_weighting:
            inco = inco + jnp.abs(vals).sum(axis=0)
        return (out, inco), None

    v = world.shape[0]
    init = (_accum_init(st, (v,)), jnp.zeros((v,), jnp.float32))
    chans = (dyn["channel_offset"].astype(jnp.float32)
             + jnp.arange(rf.shape[0], dtype=jnp.float32))
    (out, inco), _ = jax.lax.scan(chan_body, init, (chans, rf))
    return out, inco


# ---------------------------------------------------------------------------
# HERCULES / UHERCULES / HERO-PA (das.glsl:231-284)
# ---------------------------------------------------------------------------

def _rca_projection(pts: jax.Array, rows) -> jax.Array:
    """(lateral, z) projection; lateral = y when ``rows`` (das.glsl:152-156)."""
    lat = jnp.where(rows, pts[..., 1], pts[..., 0])
    return jnp.stack([lat, pts[..., 2]], axis=-1)


def _rca_transmit_distance(dyn, world: jax.Array, angle_deg, depth,
                           tx_orientation) -> jax.Array:
    """Plane/cylindrical transmit distance (das.glsl:158-200); traced
    orientation handled with selects."""
    tx_rows = tx_orientation == RCAOrientation.Rows.value
    angle = jnp.radians(angle_deg)
    proj = _rca_projection(world, tx_rows)
    plane = proj[..., 0] * jnp.sin(angle) + proj[..., 1] * jnp.cos(angle)
    safe_depth = jnp.where(jnp.isinf(depth), 0.0, depth)
    f_lat = safe_depth * jnp.sin(angle)
    f_z = safe_depth * jnp.cos(angle)
    cyl = jnp.sqrt((proj[..., 0] - f_lat) ** 2 + (proj[..., 1] - f_z) ** 2)
    dist = jnp.where(jnp.isinf(depth), plane, cyl)
    return jnp.where(tx_orientation == RCAOrientation.NoOrientation.value,
                     0.0, dist)


def _hercules_block(st: DasStatic, dyn, rf: jax.Array, world: jax.Array):
    xdc_world = _apply_m4(dyn["xdc_transform"], world)
    orient = dyn["orientations"][0]
    tx_o = (orient >> 4) & 0xF
    rx_o = orient & 0xF
    rx_cols = rx_o == RCAOrientation.Columns.value
    fv = dyn["focal_vectors"][0]

    tx_index = _sample_index(
        dyn, _rca_transmit_distance(dyn, world, fv[0], fv[1], tx_o))
    z = xdc_world[:, 2]
    z2 = z * z
    fnum_over_z = jnp.abs(dyn["f_number"] / z)
    apod_test = 0.25 / (fnum_over_z * fnum_over_z)
    xw, yw = xdc_world[:, 0], xdc_world[:, 1]
    px = dyn["xdc_element_pitch"][0]
    py = dyn["xdc_element_pitch"][1]

    sparse = int(st.sparse)
    n_tx = st.acquisition_count - sparse
    if st.sparse:
        tx_ch = dyn["sparse_elements"][:n_tx].astype(jnp.float32)
    else:
        tx_ch = jnp.arange(sparse, st.acquisition_count, dtype=jnp.float32)
    # rx_cols: rx varies x, tx varies y; else swapped (das.glsl:252-267)
    tx_d2 = jnp.where(rx_cols,
                      (yw[None, :] - tx_ch[:, None] * py) ** 2,
                      (xw[None, :] - tx_ch[:, None] * px) ** 2)
    # First-transmit 1/sqrt(N) weight (das.glsl:271-273) applies to the
    # *loop* transmit index, i.e. only when not sparse (loop starts at 1).
    first_w = jnp.where(
        jnp.arange(sparse, st.acquisition_count) == 0,
        1.0 / np.sqrt(st.acquisition_count), 1.0).astype(jnp.float32)

    fs_over_c = dyn["sampling_frequency"] / dyn["speed_of_sound"]

    def chan_body(acc, inputs):
        out, inco = acc
        ch, rf_c = inputs
        rx_d2 = jnp.where(rx_cols, (xw - ch * px) ** 2, (yw - ch * py) ** 2)
        d2 = rx_d2[None, :] + tx_d2                        # (n_tx, V)
        mask = d2 < apod_test[None, :]
        apod = first_w[:, None] * _apodize(
            jnp.where(mask, fnum_over_z[None, :] * jnp.sqrt(d2), 0))
        index = tx_index[None, :] + jnp.sqrt(z2[None, :] + d2) * fs_over_c
        lines = rf_c[sparse:, :]
        vals = _sample_rf(st, dyn, lines, index)
        vals = jnp.where(mask, apod * vals, 0)
        out = out + vals.sum(axis=0)
        if st.coherency_weighting:
            inco = inco + jnp.abs(vals).sum(axis=0)
        return (out, inco), None

    v = world.shape[0]
    init = (_accum_init(st, (v,)), jnp.zeros((v,), jnp.float32))
    chans = (dyn["channel_offset"].astype(jnp.float32)
             + jnp.arange(rf.shape[0], dtype=jnp.float32))
    (out, inco), _ = jax.lax.scan(chan_body, init, (chans, rf))
    return out, inco


# ---------------------------------------------------------------------------
# RCA: Flash / TPW / VLS (das.glsl:202-229)
# ---------------------------------------------------------------------------

def _rca_block(st: DasStatic, dyn, rf: jax.Array, world: jax.Array):
    xdc_world = _apply_m4(dyn["xdc_transform"], world)
    px = dyn["xdc_element_pitch"][0]
    py = dyn["xdc_element_pitch"][1]
    chans = (dyn["channel_offset"].astype(jnp.float32)
             + jnp.arange(rf.shape[0], dtype=jnp.float32))

    def acq_body(acc, inputs):
        out, inco = acc
        orient, fv, rf_a = inputs              # rf_a: (C, S)
        tx_o = (orient >> 4) & 0xF
        rx_o = orient & 0xF
        rx_rows = rx_o == RCAOrientation.Rows.value
        xdc_proj = _rca_projection(xdc_world, rx_rows)       # (V, 2)
        tx_dist = _rca_transmit_distance(dyn, world, fv[0], fv[1], tx_o)

        rx_lat = jnp.where(rx_rows, chans * py, chans * px)  # (C,)
        recv_lat = xdc_proj[None, :, 0] - rx_lat[:, None]    # (C, V)
        recv_z = xdc_proj[None, :, 1]
        a_arg = jnp.abs(dyn["f_number"] * recv_lat / jnp.abs(recv_z))
        mask = a_arg < 0.5
        apod = _apodize(jnp.where(mask, a_arg, 0))
        rlen = jnp.sqrt(recv_lat * recv_lat + recv_z * recv_z)
        index = _sample_index(dyn, tx_dist[None, :] + rlen)  # (C, V)
        vals = _sample_rf(st, dyn, rf_a, index)
        vals = jnp.where(mask, apod * vals, 0)
        out = out + vals.sum(axis=0)
        if st.coherency_weighting:
            inco = inco + jnp.abs(vals).sum(axis=0)
        return (out, inco), None

    v = world.shape[0]
    init = (_accum_init(st, (v,)), jnp.zeros((v,), jnp.float32))
    (out, inco), _ = jax.lax.scan(
        acq_body, init,
        (dyn["orientations"], dyn["focal_vectors"], rf.transpose(1, 0, 2)))
    return out, inco


_FAMILY_BLOCK = {
    "forces": _forces_block,
    "hercules": _hercules_block,
    "rca": _rca_block,
}


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def das(rf: jax.Array, dyn: dict, st: DasStatic):
    """DAS a full frame.  ``rf``: (C, A, S) — or (B, C, A, S) when
    ``st.frame_batch == B > 1``, returning (B, nx, ny, nz).  Returns the
    (nx, ny, nz) coherent volume, or ``(coherent, incoherent)`` with
    coherency weighting.

    Traceable; wrap in jit with ``st`` static (see :func:`das_jit`).
    """
    if st.frame_batch > 1:
        if rf.shape[0] != st.frame_batch:
            raise ValueError(f"rf leading dim {rf.shape[0]} != "
                             f"frame_batch {st.frame_batch}")
        if st.backend in ("pallas", "pallas_interpret"):
            return das_gpu.das_gpu(rf, dyn, st,
                                   interpret=st.backend == "pallas_interpret")
        st1 = dataclasses.replace(st, frame_batch=1)
        return jax.vmap(lambda f: das(f, dyn, st1))(rf)
    if st.family == "none":
        # Reference dispatch has no case for this kind (das.glsl:381-400):
        # the frame stays zero.
        nx, ny, nz = st.output_points
        zero = jnp.zeros((nx, ny, nz),
                         jnp.complex64 if st.iq else jnp.float32)
        if st.coherency_weighting:
            return zero, jnp.zeros((nx, ny, nz), jnp.float32)
        return zero
    if st.backend in ("pallas", "pallas_interpret"):
        return das_gpu.das_gpu(rf, dyn, st,
                               interpret=st.backend == "pallas_interpret")
    if st.family == "forces" and st.readi_group_count > 1:
        block_fn = _readi_forces_block
    else:
        block_fn = _FAMILY_BLOCK[st.family]

    world = _world_points(st, dyn)
    v = world.shape[0]
    blk = min(st.voxel_block, v)
    n_blocks = -(-v // blk)
    pad = n_blocks * blk - v
    world = jnp.pad(world, ((0, pad), (0, 0)))
    world = world.reshape(n_blocks, blk, 3)

    def one_block(wp):
        return block_fn(st, dyn, rf, wp)

    out, inco = jax.lax.map(one_block, world)
    # Voxel v unravels C-order over (nx, ny, nz); the frame exporter
    # re-linearizes x-fastest to match das.glsl:130-134 when needed.
    nx, ny, nz = st.output_points
    out = out.reshape(-1)[:v].reshape(nx, ny, nz)
    if st.coherency_weighting:
        inco = inco.reshape(-1)[:v].reshape(nx, ny, nz)
        return out, inco
    return out


@partial(jax.jit, static_argnames=("st",))
def das_jit(rf: jax.Array, dyn: dict, st: DasStatic):
    return das(rf, dyn, st)


def das_from_params(rf, p: DasParams, voxel_block: int = 16384):
    """Convenience wrapper mirroring the golden ``das(rf, params)`` API."""
    st = make_static(p, iq=bool(jnp.iscomplexobj(rf)), voxel_block=voxel_block)
    dyn = make_dynamic(p)
    return das_jit(jnp.asarray(rf), dyn, st)
