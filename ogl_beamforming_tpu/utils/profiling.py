"""Device-side timing from ``jax.profiler`` traces.

The analogue of the reference bracketing every dispatch with GPU timestamps
(vulkan.c:2616-2637, beamformer_core.c:1602-1628).  ``device_time(fn,
*args)`` traces one call and reads the ``.xplane.pb`` the profiler writes
through ``jax.profiler.ProfileData``.  On the GPU, each ``/device:GPU:<n>``
plane has one line per CUDA stream ("Stream #13(Compute)" and the like),
and each event on it is one kernel or copy, named after the HLO
instruction or, for a Pallas kernel, after its ``name=``.  A trace with no
GPU plane, or no event on it, is an error: the wall clock is no stand-in
for device time.
"""

from __future__ import annotations

import glob
import os
import tempfile
from dataclasses import dataclass

import jax

_DEVICE_PLANE_PREFIX = "/device:GPU:"


@dataclass
class DeviceProfile:
    """One traced call's device-side timing."""

    busy_seconds: float        # union of event intervals on the device
    op_seconds: dict           # event name -> total seconds

    @property
    def top_ops(self):
        return sorted(self.op_seconds.items(), key=lambda kv: -kv[1])


def parse_xplane(path: str) -> DeviceProfile:
    """Device busy time and per-kernel totals from one ``.xplane.pb``."""
    data = jax.profiler.ProfileData.from_file(path)
    intervals = []
    op_ns: dict = {}
    for plane in data.planes:
        if not plane.name.startswith(_DEVICE_PLANE_PREFIX):
            continue
        for line in plane.lines:
            for ev in line.events:
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                op_ns[ev.name] = op_ns.get(ev.name, 0.0) + ev.duration_ns
    if not intervals:
        raise RuntimeError(f"no GPU device events in {path}")
    busy = 0.0
    end = float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return DeviceProfile(busy_seconds=busy * 1e-9,
                         op_seconds={k: v * 1e-9 for k, v in op_ns.items()})


def device_time(fn, *args, warmup: int = 1, logdir: str | None = None,
                **kwargs) -> DeviceProfile:
    """Trace ONE call of ``fn(*args, **kwargs)`` and return its device
    profile.  ``warmup`` untraced calls first keep compilation out of the
    trace; the traced call is waited for inside the trace window."""
    for _ in range(max(warmup, 0)):
        jax.block_until_ready(fn(*args, **kwargs))
    if logdir is None:
        with tempfile.TemporaryDirectory(prefix="bf_prof_") as tmp:
            return device_time(fn, *args, warmup=0, logdir=tmp, **kwargs)
    options = jax.profiler.ProfileOptions()
    options.python_tracer_level = 0
    with jax.profiler.trace(logdir, profiler_options=options):
        jax.block_until_ready(fn(*args, **kwargs))
    files = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                      recursive=True)
    if not files:
        raise RuntimeError(f"profiler wrote no .xplane.pb under {logdir}")
    return parse_xplane(max(files, key=os.path.getmtime))
