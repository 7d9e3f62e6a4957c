"""Multi-host feeder pattern: one RF feeder per host, one global volume.

Run ONE copy of this script per feeder host:

    python examples/multihost_feeders.py \
        --coordinator HOST0:8476 --num-hosts 4 --host-id $ID

Each host's acquisition front-end owns the channel rows cabled to it
(``local_channel_slice``); the global sharded RF array is assembled with
no cross-host copy and the DAS partial-volume ``psum`` rides the interconnect.
On a single machine it degenerates to one feeder over the local
devices — so the same script runs everywhere, which is the point.

See parallel/multihost.py for the mechanics; parity with the unsharded
plan is pinned by tests/test_multihost.py on a virtual 8-device mesh.
"""

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of process 0 (omit for single-host)")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args()

    from ogl_beamforming_tpu.parallel import multihost, sharding
    multihost.init_multihost(args.coordinator, args.num_hosts, args.host_id)

    import jax
    from ogl_beamforming_tpu.utils.device import enable_compile_cache
    enable_compile_cache()
    print(f"host {jax.process_index()}/{jax.process_count()}: "
          f"{jax.local_device_count()} local of {len(jax.devices())} devices")

    from ogl_beamforming_tpu.models.presets import plane_wave_2d
    from ogl_beamforming_tpu.pipeline.plan import build_plan
    c, s = args.channels, 4096
    p, pipe = plane_wave_2d(channel_count=c, sample_count=s)
    plan = build_plan(p, pipe, {})

    mesh = multihost.make_host_mesh()
    splan = sharding.shard_plan(plan, mesh)
    sl = multihost.local_channel_slice(c)
    rng = np.random.default_rng(jax.process_index())

    for i in range(args.frames):
        # this host's feeder produces ONLY its own channel rows
        local_rows = rng.standard_normal(
            (sl.stop - sl.start, 1, s)).astype(np.float32)
        t0 = time.perf_counter()
        rf = multihost.feed_rf(local_rows, mesh)
        out = splan(rf)
        frame = multihost.gathered_frame(out)
        print(f"frame {i}: {frame.shape} in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
