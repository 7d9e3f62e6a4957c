"""Developer hot-reload: watch op sources, invalidate compiled plans.

The analogue of the reference's inotify shader watching + library
hot-reload (main_linux.c:206-255,342-365, beamformer_core.c:1799-1853):
edited GLSL marked pipelines dirty and recompiled on the next frame.  Here
the watched units are the Python op modules; a change reloads them, clears
every jit/plan cache, and marks executor blocks dirty so the next frame
re-traces against the new code — state (parameter blocks, backlog, stats)
survives, exactly like the reference's reload keeping memory in the
platform layer.
"""

from __future__ import annotations

import importlib
import threading
import time
from pathlib import Path

_WATCHED_MODULES = [
    "ogl_beamforming_tpu.ops.decode",
    "ogl_beamforming_tpu.ops.filtering",
    "ogl_beamforming_tpu.ops.das",
    "ogl_beamforming_tpu.ops.das_gpu",
    "ogl_beamforming_tpu.ops.coherency",
    "ogl_beamforming_tpu.ops.display",
    "ogl_beamforming_tpu.pipeline.plan",
]


def invalidate_compiled(beamformers=()):
    """Clear plan/jit caches and dirty executor blocks (the reload's
    ``dirty_programs`` sweep, beamformer_core.c:1818-1845)."""
    from ..pipeline import plan as plan_mod
    plan_mod.clear_plan_cache()
    if hasattr(plan_mod, "compiled_stage_fns"):
        plan_mod.compiled_stage_fns.cache_clear()
    from ..ops import das_gpu
    das_gpu._call.cache_clear()
    for bf in beamformers:
        for block in bf._blocks:
            block.mark_dirty()
            block._plan = None


def reload_ops(beamformers=(), names=None):
    """Reload the given op modules (all watched ones by default) then
    invalidate compiled state."""
    import sys
    for name in (names if names is not None else _WATCHED_MODULES):
        if name in sys.modules:
            importlib.reload(sys.modules[name])
    invalidate_compiled(beamformers)


class SourceWatcher:
    """Poll-based watcher over the op sources (the inotify analogue)."""

    def __init__(self, beamformers=(), interval: float = 0.5,
                 on_reload=None):
        self.beamformers = list(beamformers)
        self.interval = interval
        self.on_reload = on_reload
        self._mtimes: dict[Path, float] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        for _, path in self._paths():
            self._mtimes[path] = path.stat().st_mtime

    def _paths(self):
        import sys
        for name in _WATCHED_MODULES:
            mod = sys.modules.get(name)
            if mod is None:
                importlib.import_module(name)
                mod = sys.modules[name]
            yield name, Path(mod.__file__)

    def poll_once(self) -> bool:
        """Check mtimes; reload changed modules.  Returns True if any
        reloaded (only the edited modules reload — the analogue of the
        reference's per-shader dirty bits)."""
        changed = []
        for name, path in self._paths():
            mtime = path.stat().st_mtime
            if mtime != self._mtimes.get(path):
                self._mtimes[path] = mtime
                changed.append(name)
        if changed:
            reload_ops(self.beamformers, changed)
            if self.on_reload:
                self.on_reload()
        return bool(changed)

    def start(self):
        def loop():
            while not self._stop.is_set():
                try:
                    self.poll_once()
                except Exception:
                    pass
                self._stop.wait(self.interval)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="beamformer-hotreload")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
