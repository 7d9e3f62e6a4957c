"""Multi-host scale-out: per-host RF feeders into a global device mesh.

The reference is a single-node system; its ingest path is one producer
process writing RF into the shm scratch (lib/ogl_beamformer_lib.c:491-570).
At multi-host scale the acquisition front-end fans out across hosts: each
host's feeder owns the channel rows physically cabled to it, uploads them
to its *local* devices only, and the DAS partial-volume reduction rides
the interconnect (parallel/sharding.py).  The assembly primitive is
``jax.make_array_from_process_local_data``: the global (C, A, S) RF array
is built from host-local channel shards with **no cross-host gather** —
RF bytes never leave the host that acquired them until they are decoded,
filtered and beamformed down to a partial volume.

Single-process (tests, one-host machines) degenerates cleanly: the local
shard is the whole array and every helper works unchanged on a virtual
device mesh.
"""

from __future__ import annotations

import numpy as np

from .sharding import CHANNEL_AXIS, SLAB_AXIS, rf_sharding


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> bool:
    """Bring up the JAX distributed runtime (no-op when single-process).

    Call once per feeder host before any device use, mirroring how the
    reference's platform layer creates its shared memory before workers
    start (beamformer.c:246-305).  Returns True when a multi-process
    runtime was initialized.
    """
    import jax
    if num_processes in (None, 1):
        return False
    jax.distributed.initialize(coordinator_address, num_processes,
                               process_id)
    return True


def make_host_mesh(channel_axis: str = CHANNEL_AXIS,
                   slab_axis: str | None = None, slab_devices: int = 1):
    """Global mesh whose channel axis is *host-major*.

    Devices are arranged (process, local_device) so consecutive channel
    shards of one host land on that host's chips — the feeder's channel
    rows upload over PCIe only, never DCN.  With ``slab_axis`` the local
    device dimension is split (channels x slabs) as in
    :func:`..parallel.sharding.make_mesh_2d`.
    """
    import jax
    from jax.sharding import Mesh

    n_proc = jax.process_count()
    n_local = jax.local_device_count()
    # Host-major order without assuming anything about global device ids:
    # JAX guarantees neither contiguity nor alignment of d.id across
    # processes, so sort by (process, id) and fill slots positionally.
    ordered = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    devs = np.empty((n_proc, n_local), dtype=object)
    counts = np.zeros(n_proc, dtype=int)
    for d in ordered:
        p = d.process_index
        if not 0 <= p < n_proc or counts[p] >= n_local:
            raise RuntimeError(
                f"device {d} breaks the homogeneous-pod assumption "
                f"({n_proc} processes x {n_local} local devices)")
        devs[p, counts[p]] = d
        counts[p] += 1
    if not (counts == n_local).all():
        raise RuntimeError(f"uneven devices per process: {counts.tolist()}")
    grid = devs.reshape(-1)          # host-major flat order
    if slab_axis is None:
        return Mesh(grid, (channel_axis,))
    total = n_proc * n_local
    if total % slab_devices:
        raise ValueError(f"{total} devices not divisible into "
                         f"{slab_devices} slabs")
    # A channel shard's slab replicas must stay on one host or feed_rf's
    # no-cross-host-copy contract breaks: the local device count must tile
    # into whole slab groups.
    if n_local % slab_devices:
        raise ValueError(
            f"slab_devices={slab_devices} must divide the local device "
            f"count {n_local}: a channel shard's slab group may not span "
            f"hosts")
    return Mesh(grid.reshape(total // slab_devices, slab_devices),
                (channel_axis, slab_axis))


def local_channel_slice(channel_count: int) -> slice:
    """The global channel rows this host's feeder owns: the contiguous
    block matching the host-major mesh order of :func:`make_host_mesh`.
    Valid only for meshes built by :func:`make_host_mesh` (host-major
    channel axis); a differently-ordered mesh needs its own slicing."""
    import jax
    n_proc = jax.process_count()
    if channel_count % n_proc:
        raise ValueError(f"channel count {channel_count} not divisible by "
                         f"{n_proc} hosts")
    per = channel_count // n_proc
    p = jax.process_index()
    return slice(p * per, (p + 1) * per)


def feed_rf(rf_local, mesh, channel_axis: str = CHANNEL_AXIS):
    """Assemble the global sharded (C, A, S) RF array from this host's
    channel rows (``rf_local``: the :func:`local_channel_slice` block).

    Each process contributes only its local shard; the result is a global
    ``jax.Array`` laid out per :func:`..parallel.sharding.rf_sharding`,
    ready for ``shard_plan``-wrapped pipelines — the multi-host analogue
    of the reference's scratch->GPU upload thread
    (beamformer_core.c:1728-1777).
    """
    import jax
    sharding = rf_sharding(mesh, channel_axis)
    global_shape = (rf_local.shape[0] * jax.process_count(),
                    *rf_local.shape[1:])
    return jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(rf_local), global_shape)


def gathered_frame(out) -> np.ndarray:
    """Fetch the (replicated or slab-sharded) output volume to this host.

    Every host holds the full volume for replicated outputs; slab-sharded
    outputs are fetched addressable-shard-wise and reassembled.
    """
    import jax
    if isinstance(out, jax.Array) and not out.is_fully_addressable:
        # assemble from the addressable shards of every process
        import jax.experimental.multihost_utils as mh
        return np.asarray(mh.process_allgather(out, tiled=True))
    return np.asarray(out)
