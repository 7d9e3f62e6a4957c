"""Delay-and-sum as one GPU kernel (Pallas, Triton route).

The structure is the reference shader's (das.glsl:286-400): one program per
tile of voxels, the channel and transmit loops inside the program, masked
gathers from the RF lines, accumulators in registers and one store per
tile.  A (tile, channel) step in which no voxel of the tile lies inside the
f-number cone is skipped by a per-program branch (das.glsl:301 skips the
same work per voxel); HERCULES, whose cone depends on the transmit too,
also skips (tile, channel, transmit) steps.  The maths is ``ops/das.py``'s,
which stays the plain reference; the two differ only in summation order.

Tiles put 32 voxels along x (lateral in every preset) on neighbouring
lanes, so the lanes of a warp gather from nearby RF samples, and stack
``TILE // 32`` rows of the remaining grid axes under them.

Families: FORCES/UFORCES, HERCULES/UHERCULES/HERO-PA and RCA (Flash, TPW,
VLS), real or IQ, any interpolation, coherency weighting, channel shards
(``channel_offset``/``grid_channels``), x-slabs (``x_offset``/
``global_points``) and frame batches (``vmap`` adds a grid axis).  READI's
Hadamard-weighted groups stay on ``ops/das.py`` (:func:`supports`).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..params.enums import InterpolationMode, RCAOrientation

TILE = 128
"""Voxels per program: a power of two, chosen on the card (PERF.md)."""
NUM_WARPS = 4
LANE_X = 32
"""Voxels along x on neighbouring lanes (one warp's width)."""

# Per-acquisition transmit/receive table columns (RCA and HERCULES).
_SIN, _COS, _DEPTH, _PLANE, _TX_ROWS, _TX_NONE, _RX_ROWS, _RX_COLS = range(8)
_ACQ_COLS = 8

# Scalar table (f32): voxel transform rows, xdc transform rows, then these.
(_PX, _PY, _FS, _FD, _SOS, _T0, _FNUM, _CH_OFF, _X_OFF) = range(24, 33)
_N_SCALARS = 33


def supports(st) -> bool:
    """Families this kernel implements; READI groups and kinds without a
    dispatch case stay on ``ops/das.py``."""
    if st.family == "forces":
        return st.readi_group_count <= 1
    return st.family in ("hercules", "rca")


def _if_any(mask, fn, acc):
    """``fn(acc)`` when any lane of ``mask`` is set, else ``acc``: the
    per-program branch that skips a step for the whole tile."""
    return jax.lax.cond(jnp.max(mask.astype(jnp.int32)) > 0, fn,
                        lambda acc: acc, acc)


def _tiling(st):
    """(lanes along x, x tiles, grid size) for the output grid."""
    nx, ny, nz = st.output_points
    bx = min(LANE_X, pl.next_power_of_2(nx))
    n_xt = -(-nx // bx)
    return bx, n_xt, n_xt * -(-(ny * nz) // (TILE // bx))


def _round_half_even(x):
    """``jnp.round`` from floor and selects (Triton has no round)."""
    t = jnp.floor(x)
    d = x - t
    odd = t - 2.0 * jnp.floor(0.5 * t)
    return jnp.where(d > 0.5, t + 1.0, jnp.where(d < 0.5, t, t + odd))


def _interpolate(mode, s, index, base, live, planes):
    """Fractional-delay lookup of one RF line per plane (das.glsl:64-122,
    ``ops/das.py::_interpolate``).  ``base``: flat offset of the line;
    lanes outside ``live`` or the sample range read nothing and give 0."""
    if mode == InterpolationMode.Nearest:
        r = _round_half_even(index)
        valid = (jnp.floor(index) >= 0) & (r < s) & live
        k = base + jnp.clip(r.astype(jnp.int32), 0, s - 1)
        return valid, [plt.load(p.at[k], mask=valid, other=0.0)
                       for p in planes]
    k = jnp.floor(index)
    t = index - k
    if mode == InterpolationMode.Linear:
        valid = (k >= 0) & (k < s - 1) & live
        kk = base + jnp.clip(k.astype(jnp.int32), 0, s - 2)
        out = []
        for p in planes:
            v0 = plt.load(p.at[kk], mask=valid, other=0.0)
            v1 = plt.load(p.at[kk + 1], mask=valid, other=0.0)
            out.append((1 - t) * v0 + t * v1)
        return valid, out
    # Cubic Catmull-Rom (C_SPLINE = 0.5, das.glsl:49,64-95)
    valid = (k > 0) & (k < s - 2) & live
    kk = base + jnp.clip(k.astype(jnp.int32), 1, s - 3)
    tt = t * t
    ttt = tt * t
    c1 = 2 * ttt - 3 * tt + 1
    c2 = -2 * ttt + 3 * tt
    c3 = ttt - 2 * tt + t
    c4 = ttt - tt
    out = []
    for p in planes:
        p0, p1, p2, p3 = (plt.load(p.at[kk + o], mask=valid, other=0.0)
                          for o in (-1, 0, 1, 2))
        out.append(c1 * p1 + c2 * p2 + c3 * (0.5 * (p2 - p0))
                   + c4 * (0.5 * (p3 - p1)))
    return valid, out


def _accumulate(st, sc, acc, index, base, live, weight, planes):
    """Sample one line, rotate IQ, weight, and add into ``acc``
    (coherent planes, then the incoherent sum when coherency is on)."""
    valid, vals = _interpolate(st.interpolation_mode, st.sample_count,
                               index, base, live, planes)
    if st.iq:
        arg = (2.0 * np.pi) * sc[_FD] * (index / sc[_FS])
        c, s = jnp.cos(arg), jnp.sin(arg)
        re, im = vals
        vals = [re * c - im * s, re * s + im * c]
    vals = [jnp.where(valid, weight * v, 0.0) for v in vals]
    out = [a + v for a, v in zip(acc, vals)]
    if st.coherency_weighting:
        mag = (jnp.sqrt(vals[0] * vals[0] + vals[1] * vals[1]) if st.iq
               else jnp.abs(vals[0]))
        out.append(acc[-1] + mag)
    return tuple(out)


def _apodize(arg):
    a = jnp.cos(np.pi * arg)
    return a * a


def _tile_points(st, sc):
    """World points of this program's tile and the lanes inside the grid.
    Returns (x, y, z, flat output offset, in-grid mask)."""
    nx, ny, nz = st.output_points
    gnx, gny, gnz = st.global_points or (nx, ny, nz)
    rows = ny * nz
    bx, n_xt, _ = _tiling(st)
    br = TILE // bx
    pid = pl.program_id(0)
    tile_r = jax.lax.div(pid, n_xt)
    tile_x = pid - tile_r * n_xt
    lane = jax.lax.iota(jnp.int32, TILE)
    lane_r = jax.lax.div(lane, bx)
    ix = tile_x * bx + (lane - lane_r * bx)
    r = tile_r * br + lane_r
    iy = jax.lax.div(r, nz)
    iz = r - iy * nz
    in_grid = (ix < nx) & (r < rows)
    gx = (ix.astype(jnp.float32) + sc[_X_OFF]) / max(gnx - 1.0, 1.0)
    gy = iy.astype(jnp.float32) / max(gny - 1.0, 1.0)
    gz = iz.astype(jnp.float32) / max(gnz - 1.0, 1.0)
    w = [sc[4 * i] * gx + sc[4 * i + 1] * gy + sc[4 * i + 2] * gz
         + sc[4 * i + 3] for i in range(3)]
    # Lanes outside the grid own slots past its end, so no two lanes of a
    # store share an address (the caller drops those slots).
    flat = jnp.where(in_grid, ix * rows + r, nx * rows + lane)
    return w[0], w[1], w[2], flat, in_grid


def _xdc(sc, x, y, z):
    """Apply the xdc transform (rows 3..5 of the scalar table)."""
    return [sc[12 + 4 * i] * x + sc[13 + 4 * i] * y + sc[14 + 4 * i] * z
            + sc[15 + 4 * i] for i in range(3)]


def _sample_index(sc, distance):
    return (distance / sc[_SOS] + sc[_T0]) * sc[_FS]


def _transmit_distance(acq, x, z_or_y, z):
    """Plane/cylindrical transmit distance for one acquisition row
    (das.glsl:158-200, ``ops/das.py::_rca_transmit_distance``)."""
    lat = jnp.where(acq[_TX_ROWS] > 0, z_or_y, x)
    plane = lat * acq[_SIN] + z * acq[_COS]
    f_lat = acq[_DEPTH] * acq[_SIN]
    f_z = acq[_DEPTH] * acq[_COS]
    cyl = jnp.sqrt((lat - f_lat) * (lat - f_lat) + (z - f_z) * (z - f_z))
    dist = jnp.where(acq[_PLANE] > 0, plane, cyl)
    return jnp.where(acq[_TX_NONE] > 0, 0.0, dist)


def _forces_body(st, sc, x, y, z, in_grid, tx_ref, planes, acc):
    c_local = st.local_channels
    a, s = st.acquisition_count, st.sample_count
    sparse = int(st.sparse)
    n_tx = a - sparse
    z2 = z * z
    ty = y - sc[_PY] * (st.channel_count / 2)
    t_yz2 = ty * ty + z2
    fs_over_c = sc[_FS] / sc[_SOS]

    def channel(c, acc):
        rx_dx = x - (sc[_CH_OFF] + c.astype(jnp.float32)) * sc[_PX]
        a_arg = jnp.abs(sc[_FNUM] * rx_dx / z)
        live = (a_arg < 0.5) & in_grid

        def run(acc):
            apod = _apodize(jnp.where(live, a_arg, 0.0))
            rx_index = _sample_index(sc, jnp.sqrt(rx_dx * rx_dx + z2))

            def transmit(t, acc):
                tx_dx = x - sc[_PX] * tx_ref[t]
                index = rx_index + jnp.sqrt(t_yz2 + tx_dx * tx_dx) * fs_over_c
                base = ((c * a + t + sparse) * s).astype(jnp.int32)
                return _accumulate(st, sc, acc, index, base, live, apod,
                                   planes)

            return jax.lax.fori_loop(0, n_tx, transmit, acc)

        return _if_any(live, run, acc)

    return jax.lax.fori_loop(0, c_local, channel, acc)


def _hercules_body(st, sc, x, y, z, in_grid, tx_ref, acq_ref, planes, acc):
    a, s = st.acquisition_count, st.sample_count
    sparse = int(st.sparse)
    n_tx = a - sparse
    acq = [acq_ref[j] for j in range(_ACQ_COLS)]
    tx_index = _sample_index(sc, _transmit_distance(acq, x, y, z))
    xw, yw, zw = _xdc(sc, x, y, z)
    z2 = zw * zw
    fnum_over_z = jnp.abs(sc[_FNUM] / zw)
    apod_test = 0.25 / (fnum_over_z * fnum_over_z)
    rx_cols = acq[_RX_COLS] > 0
    fs_over_c = sc[_FS] / sc[_SOS]
    first_w = 1.0 / np.sqrt(a)

    def channel(c, acc):
        ch = sc[_CH_OFF] + c.astype(jnp.float32)
        rx_d = jnp.where(rx_cols, xw - ch * sc[_PX], yw - ch * sc[_PY])
        rx_d2 = rx_d * rx_d

        def run(acc):
            def transmit(t, acc):
                txc = tx_ref[t]
                tx_d = jnp.where(rx_cols, yw - txc * sc[_PY],
                                 xw - txc * sc[_PX])
                d2 = rx_d2 + tx_d * tx_d
                live = (d2 < apod_test) & in_grid

                def add(acc):
                    w = _apodize(jnp.where(live, fnum_over_z * jnp.sqrt(d2),
                                           0.0))
                    if not sparse:       # first transmit (das.glsl:271-273)
                        w = w * jnp.where(t == 0, first_w, 1.0)
                    index = tx_index + jnp.sqrt(z2 + d2) * fs_over_c
                    base = ((c * a + t + sparse) * s).astype(jnp.int32)
                    return _accumulate(st, sc, acc, index, base, live, w,
                                       planes)

                return _if_any(live, add, acc)

            return jax.lax.fori_loop(0, n_tx, transmit, acc)

        return _if_any((rx_d2 < apod_test) & in_grid, run, acc)

    return jax.lax.fori_loop(0, st.local_channels, channel, acc)


def _rca_body(st, sc, x, y, z, in_grid, acq_ref, planes, acc):
    a, s = st.acquisition_count, st.sample_count
    xw, yw, zw = _xdc(sc, x, y, z)
    rz2 = zw * zw

    def acquisition(i, acc):
        acq = [acq_ref[i * _ACQ_COLS + j] for j in range(_ACQ_COLS)]
        rx_rows = acq[_RX_ROWS] > 0
        lat = jnp.where(rx_rows, yw, xw)
        pitch = jnp.where(rx_rows, sc[_PY], sc[_PX])
        tx_dist = _transmit_distance(acq, x, y, z)

        def channel(c, acc):
            recv_lat = lat - (sc[_CH_OFF] + c.astype(jnp.float32)) * pitch
            a_arg = jnp.abs(sc[_FNUM] * recv_lat / jnp.abs(zw))
            live = (a_arg < 0.5) & in_grid

            def add(acc):
                apod = _apodize(jnp.where(live, a_arg, 0.0))
                rlen = jnp.sqrt(recv_lat * recv_lat + rz2)
                index = _sample_index(sc, tx_dist + rlen)
                base = ((c * a + i) * s).astype(jnp.int32)
                return _accumulate(st, sc, acc, index, base, live, apod,
                                   planes)

            return _if_any(live, add, acc)

        return jax.lax.fori_loop(0, st.local_channels, channel, acc)

    return jax.lax.fori_loop(0, a, acquisition, acc)


def _kernel(st, sc_ref, tx_ref, acq_ref, *refs):
    n_planes = 2 if st.iq else 1
    planes = refs[:n_planes]
    outs = refs[n_planes:]
    sc = [sc_ref[i] for i in range(_N_SCALARS)]
    x, y, z, flat, in_grid = _tile_points(st, sc)
    acc = tuple(jnp.zeros((TILE,), jnp.float32) for _ in outs)
    if st.family == "forces":
        acc = _forces_body(st, sc, x, y, z, in_grid, tx_ref, planes, acc)
    elif st.family == "hercules":
        acc = _hercules_body(st, sc, x, y, z, in_grid, tx_ref, acq_ref,
                             planes, acc)
    else:
        acc = _rca_body(st, sc, x, y, z, in_grid, acq_ref, planes, acc)
    for o, v in zip(outs, acc):
        plt.store(o.at[flat], v, mask=in_grid)


def _tables(st, dyn):
    """Scalar, transmit-position and per-acquisition tables from the
    traced parameters (the shader's push constants and uniform arrays)."""
    f32 = jnp.float32
    sc = jnp.concatenate([
        dyn["voxel_transform"][:3].reshape(-1).astype(f32),
        dyn["xdc_transform"][:3].reshape(-1).astype(f32),
        jnp.stack([dyn["xdc_element_pitch"][0], dyn["xdc_element_pitch"][1],
                   dyn["sampling_frequency"], dyn["demodulation_frequency"],
                   dyn["speed_of_sound"], dyn["time_offset"],
                   dyn["f_number"],
                   dyn["channel_offset"].astype(f32),
                   dyn.get("x_offset", jnp.int32(0)).astype(f32)]).astype(f32),
    ])
    sparse = int(st.sparse)
    n_tx = st.acquisition_count - sparse
    if st.sparse:
        tx = dyn["sparse_elements"][:n_tx].astype(f32)
    else:
        tx = jnp.arange(sparse, st.acquisition_count, dtype=f32)
    orient = dyn["orientations"]
    tx_o = (orient >> 4) & 0xF
    rx_o = orient & 0xF
    angle = jnp.radians(dyn["focal_vectors"][:, 0])
    depth = dyn["focal_vectors"][:, 1]
    plane = jnp.isinf(depth)
    acq = jnp.stack([
        jnp.sin(angle), jnp.cos(angle), jnp.where(plane, 0.0, depth),
        plane, tx_o == RCAOrientation.Rows.value,
        tx_o == RCAOrientation.NoOrientation.value,
        rx_o == RCAOrientation.Rows.value,
        rx_o == RCAOrientation.Columns.value], axis=-1).astype(f32)
    return sc, tx, acq.reshape(-1)


@functools.lru_cache(maxsize=64)
def _call(st, interpret: bool):
    v = int(np.prod(st.output_points))
    grid = (_tiling(st)[2],)
    n_out = (2 if st.iq else 1) + int(st.coherency_weighting)
    return pl.pallas_call(
        functools.partial(_kernel, st),
        grid=grid,
        out_shape=[jax.ShapeDtypeStruct((v + TILE,), jnp.float32)] * n_out,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name=f"das_{st.family}",
    )


def das_gpu(rf: jax.Array, dyn: dict, st, interpret: bool = False):
    """DAS a frame with the kernel: same contract as ``ops/das.py::das``
    (``rf`` (C, A, S), or (B, C, A, S) with ``st.frame_batch == B``)."""
    if not supports(st):
        raise ValueError(f"no GPU DAS kernel for family {st.family!r} "
                         f"with {st.readi_group_count} READI groups")
    single = dataclasses.replace(st, frame_batch=1)
    sc, tx, acq = _tables(single, dyn)
    call = _call(single, interpret)
    nvox = int(np.prod(st.output_points))

    def frame(x):
        if st.iq:
            planes = (jnp.real(x).reshape(-1), jnp.imag(x).reshape(-1))
        else:
            planes = (x.astype(jnp.float32).reshape(-1),)
        outs = [o[:nvox] for o in call(sc, tx, acq, *planes)]
        shape = st.output_points
        if st.iq:
            coh = jax.lax.complex(outs[0], outs[1]).reshape(shape)
        else:
            coh = outs[0].reshape(shape)
        if st.coherency_weighting:
            return coh, outs[-1].reshape(shape)
        return coh

    if st.frame_batch > 1:
        return jax.vmap(frame)(rf)
    return frame(rf)
