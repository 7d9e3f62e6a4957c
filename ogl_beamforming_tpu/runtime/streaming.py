"""Streaming ingest: overlapped host prep, H2D upload, and device compute.

The reference overlaps RF upload and compute with dedicated threads, a
3-slot GPU ring buffer, and cross-queue timeline semaphores
(beamformer.c:292-305, beamformer_core.c:1728-1777,
beamformer_internal.h:341-353).  Here the same latency pipeline is built
from JAX's async dispatch: a prep thread applies the channel-mapping
permutation and stages the host->device transfer for frame n+1 while frame
n's compute is still in flight, and completed frames are drained lazily.
``depth`` bounds in-flight frames exactly like MaxRawDataFramesInFlight.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

import jax
import numpy as np

from ..params.constants import MAX_RAW_DATA_FRAMES_IN_FLIGHT
from ..params.enums import ContrastMode, LiveImagingDirtyFlags
from ..pipeline.executor import Beamformer, Frame
from .upload import prepare_rf


@dataclass
class FrameHandle:
    """A frame whose compute may still be in flight."""

    future: Future

    def result(self, timeout: float | None = None) -> Frame:
        return self.future.result(timeout)

    def done(self) -> bool:
        return self.future.done()


class StreamingSession:
    """Continuous-ingest wrapper around a :class:`Beamformer`.

    Usage::

        with StreamingSession(bf, block=0) as stream:
            for raw in scanner:
                handle = stream.submit(raw)       # non-blocking
            last = handle.result()

    ``submit`` returns immediately once fewer than ``depth`` frames are in
    flight (applying back-pressure beyond that, like the reference's ring
    slot spin-wait, beamformer_core.c:1560-1575).
    """

    def __init__(self, beamformer: Beamformer, block: int = 0,
                 depth: int = MAX_RAW_DATA_FRAMES_IN_FLIGHT,
                 image_plane_tag: int = 0, stop_check=None):
        self.beamformer = beamformer
        self.block = block
        self.depth = depth
        self.image_plane_tag = image_plane_tag
        self._stop_check = (self._live_stop_requested if stop_check is None
                            else stop_check)
        self.stop_requested = False
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="beamformer-stream")
        self._stopped = False
        self._thread.start()

    def _live_stop_requested(self) -> bool:
        """Default stop predicate: live-imaging control asked to stop
        (reference client loop, tests/throughput.c:558-560).  Peeks at the
        pending dirty flags without consuming them — the flag queue belongs
        to polling clients."""
        bf = self.beamformer
        if getattr(bf, "_stop_latch", False):
            return True
        live = bf.get_live_parameters()
        pending = getattr(bf, "_live_dirty", 0)
        return bool(not getattr(live, "active", 1)
                    and pending & LiveImagingDirtyFlags.StopImaging)

    # -- producer side --------------------------------------------------

    def submit(self, raw: np.ndarray,
               image_plane_tag: int | None = None) -> FrameHandle:
        """Queue one raw frame; blocks only when ``depth`` frames are
        already in flight.  After a live StopImaging request the frame is
        dropped and the handle resolves to ``None``."""
        if self._stopped:
            raise RuntimeError("session closed")
        fut: Future = Future()
        if self.stop_requested:
            fut.set_result(None)
            return FrameHandle(future=fut)
        tag = self.image_plane_tag if image_plane_tag is None \
            else image_plane_tag
        self._queue.put((np.asarray(raw), tag, fut))
        return FrameHandle(future=fut)

    def flush(self):
        """Block until every queued frame has been prepped and dispatched
        (not necessarily completed on device — see :meth:`drain`)."""
        self._queue.join()

    # -- worker ---------------------------------------------------------

    def _worker(self):
        bf = self.beamformer
        prev_frame = None
        prev_done_t = None
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            raw, tag, fut = item
            try:
                if not self.stop_requested and self._stop_check is not None \
                        and self._stop_check():
                    self.stop_requested = True
                if self.stop_requested:
                    fut.set_result(None)
                    continue
                b = bf._block(self.block)
                p = b.parameters
                rf = prepare_rf(raw, b.channel_mapping, p.channel_count,
                                p.acquisition_count, p.sample_count,
                                ContrastMode(p.contrast_mode),
                                b.pipeline.data_kind)
                bf.stats.record_rf_upload()
                # Async dispatch: device_put + compute enqueue return before
                # the device finishes; completion is observed by the consumer
                # via Frame data access (or stats in profile mode).
                plan = bf._ensure_plan(b)
                rf_dev = jax.device_put(rf)
                # calibrate stage fractions up front so their per-stage
                # compiles land in the first (compile) frame, not in the
                # middle of a timed streaming run
                bf._stage_fractions(plan, rf_dev)
                out = plan(rf_dev)
                frame = bf._register_frame(out, tag)
                fut.set_result(frame)
                # Honest device frame time: force completion of the
                # *previous* frame while this one is in flight and record
                # the completion-to-completion delta (the reference exports
                # true GPU frame times, beamformer_core.c:1602-1628 — not
                # dispatch latency, which on an async runtime is meaningless).
                if prev_frame is not None:
                    jax.block_until_ready(prev_frame.data)
                    now = time.perf_counter()
                    if prev_done_t is not None:
                        dt = now - prev_done_t
                        # sampled per-dispatch re-timing rides the same
                        # counter as the synchronous path (executor.py)
                        fr = bf._stage_fractions(plan, rf_dev)
                        bf._frames_since_calibration += 1
                        bf.stats.record_frame([dt * f for f in fr])
                    prev_done_t = now
                prev_frame = frame
            except Exception as e:          # propagate to the caller
                fut.set_exception(e)
            finally:
                self._queue.task_done()

    # -- lifecycle ------------------------------------------------------

    def drain(self):
        """Wait until every submitted frame has completed on device."""
        self.flush()
        frames = self.beamformer.get_last_frames(1)
        if frames:
            jax.block_until_ready(frames[-1].data)

    def close(self):
        if not self._stopped:
            self._stopped = True
            self._queue.put(None)
            self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
