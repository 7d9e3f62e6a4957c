"""Drive the beamformer's main path once on the GPU and check what it makes.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: channel-sharded DAS only

Phases (one card), all at the presets' full sizes through the public API:

1. device: JAX must find a GPU; prints the card's name and power limit.
2. Beamformer: push_parameters -> push_pipeline -> push_data_with_compute
   for five presets (plane wave 2D, FORCES decode->DAS, demod->decode->DAS,
   HERCULES 96^3, uFORCES 128^3), on int16 RF drawn over the full int16
   range from a fixed seed.  Per preset: the same pipeline with DAS on the
   GPU kernel and on the plain XLA path (ops/das.py), timed and compared
   (NRMSE <= 1e-4: only the summation order differs), and the kernel's
   frame against the NumPy golden chain (ops/golden.py, NRMSE <= 1e-3; a
   slab of planes for the 3D presets).  Hadamard decode at full int16
   range is compared with golden.decode_hadamard (max relative error
   <= 1e-6).
3. StreamingSession: frames of the plane-wave preset, which must equal the
   Beamformer's.
4. Shared-memory server: runtime/server.py with the native client library;
   a client thread that never touches JAX uploads FORCES frames through
   shared memory and reads the exported frames back, which must equal the
   Beamformer's.

``--four`` runs uFORCES 128^3 channel-sharded over a 1-D mesh of four
cards (a psum of partial volumes) against the same plan on one card
(NRMSE <= 1e-5: only the order of the psum differs), and nothing else.

Each phase prints one line: compile seconds, steady ms/frame (host clock
around work that ends in ``block_until_ready``), peak device bytes in use
so far, and each comparison beside its tolerance.  The last line is one
JSON object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
Any failed phase raises, so the script exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes as ct
import dataclasses
import json
import os
import threading
import time

import jax
import numpy as np

from ogl_beamforming_tpu.models import presets
from ogl_beamforming_tpu.ops import golden
from ogl_beamforming_tpu.ops.decode import decode_hadamard, hadamard_matrix
from ogl_beamforming_tpu.params.enums import (AcquisitionKind, DataKind,
                                              DecodeMode, FilterKind,
                                              InterpolationMode, ShaderKind)
from ogl_beamforming_tpu.params.types import (FilterParameters,
                                              KaiserFilterParameters,
                                              Parameters)
from ogl_beamforming_tpu.pipeline.executor import Beamformer
from ogl_beamforming_tpu.pipeline.plan import build_plan
from ogl_beamforming_tpu.runtime.streaming import StreamingSession
from ogl_beamforming_tpu.utils.device import (enable_compile_cache,
                                              gpu_name_and_power_limit,
                                              require_gpu)
from ogl_beamforming_tpu.utils.filters import make_filter
from ogl_beamforming_tpu.utils.hadamard import hadamard
from ogl_beamforming_tpu.utils.transforms import das_transform_2d_xz

SEED = 1234
FRAMES = 3
GOLDEN_THREADS = 12
GOLDEN_VOXELS_PER_THREAD = 1 << 16
"""NumPy holds the GIL between array operations, so threads only pay off
when each one's arrays are large."""


class PhaseFailed(AssertionError):
    pass


def nrmse(ref, test) -> float:
    ref, test = np.asarray(ref), np.asarray(test)
    return float(np.sqrt(np.mean(np.abs(test - ref) ** 2))
                 / np.sqrt(np.mean(np.abs(ref) ** 2)))


def peak_bytes() -> int:
    return int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])


def report(phase, checks, **fields):
    """Print the phase's line; raise if any check is out of tolerance."""
    parts = [f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
             for k, v in fields.items()]
    bad = []
    for name, value, tol in checks:
        parts.append(f"{name}={value:.3e}(tol {tol:g})")
        if not (np.isfinite(value) and value <= tol):
            bad.append(name)
    print(f"phase {phase}: " + " ".join(parts), flush=True)
    if bad:
        raise PhaseFailed(f"{phase}: {', '.join(bad)} out of tolerance")


# ---------------------------------------------------------------------------
# Presets: (parameters, pipeline, filters, sparse elements)
# ---------------------------------------------------------------------------

def _kaiser():
    return make_filter(FilterParameters(
        kind=FilterKind.Kaiser, sampling_frequency=20e6,
        kaiser=KaiserFilterParameters(2e6, 4.0, 16)))


def _forces_big():
    """FORCES on the full 512x1024 grid (bench.py's forces_big row)."""
    from ogl_beamforming_tpu.pipeline.spec import PipelineSpec
    pitch = 0.3e-3
    p = Parameters(
        sample_count=2048, channel_count=256, acquisition_count=16,
        decode_mode=DecodeMode.Hadamard,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, f_number=0.5,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Linear,
        das_voxel_transform=das_transform_2d_xz([-0.06, 0.01], [0.06, 0.165]),
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        output_points=np.array([512, 1024, 1, 0], np.int32))
    return p, PipelineSpec.from_shaders([ShaderKind.Decode, ShaderKind.DAS],
                                        DataKind.Int16), {}, None


def _presets():
    p, pipe = presets.plane_wave_2d(data_kind=DataKind.Float32Complex)
    yield "plane_wave", (p, pipe, {}, None)
    yield "forces", _forces_big()
    p, pipe = presets.forces_compounding(
        channel_count=128, transmit_count=16, sample_count=2048,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        output_points=(256, 512), demodulate=True)
    yield "demod_chain", (p, pipe, {0: _kaiser()}, None)
    p, pipe = presets.hercules_3d()
    yield "hercules", (p, pipe, {}, None)
    p, pipe, sparse = presets.uforces_volumetric()
    yield "uforces", (p, pipe, {}, sparse)


def raw_frames(p: Parameters, data_kind: DataKind, n: int, seed=SEED):
    """``n`` raw frames (C, A * S_wire) over the full int16 range."""
    rng = np.random.default_rng(seed)
    width = p.acquisition_count * p.sample_count
    if data_kind.is_complex:
        width *= 2
    frames = rng.integers(-32768, 32768, (n, p.channel_count, width),
                          dtype=np.int16)
    return frames if data_kind == DataKind.Int16 else \
        frames.astype(np.float32)


def canonical(p: Parameters, raw: np.ndarray) -> np.ndarray:
    """Raw (C, A * S_wire) frame -> (C, A, S_wire) (identity mapping)."""
    return raw.reshape(p.channel_count, p.acquisition_count, -1)


# ---------------------------------------------------------------------------
# Golden chain (NumPy), independent of the code under test
# ---------------------------------------------------------------------------

def _subgrid(vt, axis, start, count, total):
    """Voxel transform of ``count`` planes from ``start`` along ``axis``
    of a grid with ``total`` planes there."""
    s = np.eye(4, dtype=np.float64)
    denom = max(total - 1, 1)
    s[axis, axis] = max(count - 1, 1) / denom if count > 1 else 0.0
    s[axis, 3] = start / denom
    return (np.asarray(vt, np.float64) @ s).astype(np.float32)


def golden_das(rf, dp: golden.DasParams):
    """golden.das over slabs of the longest grid axis in threads (NumPy
    releases the GIL in its array loops), concatenated again."""
    axis = int(np.argmax(dp.output_points))
    total = dp.output_points[axis]
    n = min(GOLDEN_THREADS, max(total // 2, 1),
            max(int(np.prod(dp.output_points)) // GOLDEN_VOXELS_PER_THREAD, 1))
    bounds = np.linspace(0, total, n + 1).astype(int)
    jobs = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        points = list(dp.output_points)
        points[axis] = hi - lo
        jobs.append(dataclasses.replace(
            dp, voxel_transform=_subgrid(dp.voxel_transform, axis, lo,
                                         hi - lo, total),
            output_points=tuple(points)))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        parts = list(ex.map(lambda d: golden.das(rf, d), jobs))
    if dp.coherency_weighting:
        coh = np.concatenate([c for c, _ in parts], axis=axis)
        inco = np.concatenate([i for _, i in parts], axis=axis)
        return golden.coherency_weighting(coh, inco, 1.0)
    return np.concatenate(parts, axis=axis)


def golden_chain(p: Parameters, pipe, filters, sparse, rf):
    """Demodulate -> decode -> DAS -> coherency in NumPy, as the planner
    composes them (beamformer_core.c:412-467)."""
    kinds = [s.kind for s in pipe.stages]
    fs, t0 = float(p.sampling_frequency), float(p.time_offset)
    x = rf
    if pipe.data_kind.is_complex:
        x = (x[..., 0::2].astype(np.float32)
             + 1j * x[..., 1::2].astype(np.float32)).astype(np.complex64)
    if ShaderKind.Demodulate in kinds:
        f = filters[pipe.stages[kinds.index(ShaderKind.Demodulate)].parameter]
        x = golden.demodulate(x, f.taps, p.demodulation_frequency, fs, 1,
                              f.complex)
        fs, t0 = fs / 2, t0 + f.time_delay
    if ShaderKind.Decode in kinds and p.decode_mode != DecodeMode.NoDecode:
        x = golden.decode_hadamard(x, hadamard(p.acquisition_count))
    vt = np.asarray(p.das_voxel_transform, np.float32)
    if p.acquisition_kind in (AcquisitionKind.FORCES, AcquisitionKind.UFORCES):
        vt = np.asarray(p.xdc_transform, np.float32) @ vt
    from ogl_beamforming_tpu.utils.transforms import das_output_dimension
    dp = golden.DasParams(
        acquisition_kind=p.acquisition_kind,
        acquisition_count=p.acquisition_count,
        channel_count=p.channel_count, sample_count=x.shape[-1],
        sampling_frequency=fs,
        demodulation_frequency=p.demodulation_frequency,
        speed_of_sound=p.speed_of_sound, time_offset=t0,
        interpolation_mode=p.interpolation_mode, f_number=p.f_number,
        voxel_transform=vt,
        xdc_transform=np.asarray(p.xdc_transform, np.float32),
        xdc_element_pitch=np.asarray(p.xdc_element_pitch, np.float32),
        output_points=tuple(int(v) for v in das_output_dimension(
            p.output_points[:3])),
        single_orientation=bool(p.single_orientation),
        transmit_receive_orientation=int(p.transmit_receive_orientation),
        single_focus=bool(p.single_focus),
        transmit_angle=float(p.focal_vector[0]),
        focus_depth=float(p.focal_vector[1]),
        sparse=p.acquisition_kind.sparse, sparse_elements=sparse,
        coherency_weighting=bool(p.coherency_weighting))
    return golden_das(x.astype(np.complex64 if np.iscomplexobj(x)
                               else np.float32), dp)


def slab(p: Parameters, planes=2) -> Parameters:
    """A few x-planes through the middle of a 3D preset's volume."""
    nx = int(p.output_points[0])
    q = p.copy()
    q.das_voxel_transform = _subgrid(p.das_voxel_transform, 0,
                                     nx // 2 - planes // 2, planes, nx)
    q.output_points = np.array([planes, *p.output_points[1:3], 0], np.int32)
    return q


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def make_beamformer(p, pipe, filters, sparse, mesh=None) -> Beamformer:
    bf = Beamformer(mesh=mesh)
    bf.push_parameters(p)
    bf.push_pipeline([s.kind for s in pipe.stages], pipe.data_kind,
                     [s.parameter for s in pipe.stages])
    for slot, f in filters.items():
        bf.create_filter(f.parameters, slot)
    if sparse is not None:
        bf.push_sparse_elements(sparse)
    return bf


def run_frames(bf: Beamformer, frames):
    """(first-frame seconds, steady ms/frame, last frame as numpy)."""
    t0 = time.perf_counter()
    out = bf.push_data_with_compute(frames[0])
    jax.block_until_ready(out.data)
    first = time.perf_counter() - t0
    times = []
    for raw in frames[1:]:
        t0 = time.perf_counter()
        out = bf.push_data_with_compute(raw)
        jax.block_until_ready(out.data)
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times)) * 1e3, out.to_numpy()


def timed_plan(plan, rf_dev, n=FRAMES):
    """(compile+first seconds, median ms, output) of a compiled plan."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(plan(rf_dev))
    first = time.perf_counter() - t0
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(plan(rf_dev))
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times)) * 1e3, np.asarray(out)


def phase_beamformer(name, p, pipe, filters, sparse):
    frames = raw_frames(p, pipe.data_kind, FRAMES + 1)
    bf = make_beamformer(p, pipe, filters, sparse)
    first_s, ms, frame = run_frames(bf, frames)
    rf = canonical(p, frames[-1])
    checks = []

    # DAS: the GPU kernel against ops/das.py, both on the card
    kw = dict(sparse_elements=sparse)
    kernel = build_plan(p, pipe, filters, das_backend="pallas", **kw)
    xla = build_plan(p, pipe, filters, das_backend="xla", **kw)
    rf_dev = jax.device_put(rf)
    k_first, k_ms, k_out = timed_plan(kernel, rf_dev)
    x_first, x_ms, x_out = timed_plan(xla, rf_dev)
    checks.append(("beamformer_vs_kernel_plan", nrmse(k_out, frame), 1e-6))
    checks.append(("kernel_vs_xla", nrmse(x_out, k_out), 1e-4))

    # the kernel's frame against the NumPy golden chain
    t0 = time.perf_counter()
    if int(np.count_nonzero(np.asarray(p.output_points[:3]) > 1)) == 3:
        q = slab(p)
        k_slab = np.asarray(build_plan(q, pipe, filters, das_backend="pallas",
                                       **kw)(rf_dev))
        ref = golden_chain(q, pipe, filters, sparse, rf)
        checks.append(("kernel_vs_golden_slab", nrmse(ref, k_slab), 1e-3))
    else:
        ref = golden_chain(p, pipe, filters, sparse, rf)
        checks.append(("kernel_vs_golden", nrmse(ref, k_out), 1e-3))
    golden_s = time.perf_counter() - t0

    # Hadamard decode of the raw int16 frame against golden
    if pipe.data_kind == DataKind.Int16 and \
            p.decode_mode == DecodeMode.Hadamard:
        a = p.acquisition_count
        dec = np.asarray(decode_hadamard(rf_dev, hadamard_matrix(a)))
        ref_dec = golden.decode_hadamard(rf, hadamard(a))
        checks.append(("decode_maxrel", float(
            np.abs(dec - ref_dec).max() / np.abs(ref_dec).max()), 1e-6))

    report(f"beamformer/{name}", checks, compile_first_frame_s=first_s,
           ms_per_frame=ms, kernel_plan_compile_s=k_first,
           kernel_plan_ms=k_ms, xla_plan_compile_s=x_first, xla_plan_ms=x_ms,
           golden_s=golden_s, peak_bytes=peak_bytes())
    return frames, frame


def phase_streaming(p, pipe, frames, expected):
    bf = make_beamformer(p, pipe, {}, None)
    with StreamingSession(bf) as session:
        t0 = time.perf_counter()
        session.submit(frames[0]).result()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        handles = [session.submit(raw) for raw in frames[1:]]
        out = [h.result() for h in handles]
        session.drain()
        ms = (time.perf_counter() - t0) / len(handles) * 1e3
    got = out[-1].to_numpy()
    report("streaming/plane_wave",
           [("vs_beamformer", nrmse(expected, got), 1e-6)],
           compile_first_frame_s=first, ms_per_frame=ms, frames=len(frames),
           peak_bytes=peak_bytes())


def _c_parameters(p: Parameters, cp):
    """Fill the C parameter struct from ``p`` (what a C client writes)."""
    for name, ctype in type(cp)._fields_:
        value = getattr(p, name)
        if name in ("das_voxel_transform", "xdc_transform"):
            # row-major numpy -> the reference's column-major m4
            getattr(cp, name).E[:] = list(
                np.asarray(value, np.float32).T.ravel())
        elif hasattr(ctype, "E"):
            getattr(cp, name).E[:] = list(np.asarray(value).ravel())
        elif name != "emission_parameters":
            setattr(cp, name, type(getattr(cp, name))(value))


def phase_server(p, pipe, frames, expected):
    from ogl_beamforming_tpu.runtime import abi
    from ogl_beamforming_tpu.runtime.server import BeamformerServer

    os.environ.setdefault("OGL_BEAMFORMER_SHM_NAME",
                          f"/bf_chip_smoke_{os.getpid()}")
    server = BeamformerServer(shm_size=1 << 28)
    server.start()
    result = {}

    def client():
        """The scanner side: ctypes calls into the client library only."""
        lib = server.lib
        sp = abi.CSimpleParameters()
        _c_parameters(p, sp.parameters)
        for i in range(p.channel_count):
            sp.channel_mapping[i] = i
        for i, s in enumerate(pipe.stages):
            sp.compute_stages[i] = int(s.kind)
            sp.compute_stage_parameters[i] = int(s.parameter)
        sp.compute_stages_count = len(pipe.stages)
        sp.data_kind = int(pipe.data_kind)
        if not lib.beamformer_push_simple_parameters(ct.byref(sp)):
            raise PhaseFailed(lib.beamformer_get_last_error_string())
        nx, ny, nz = expected.shape
        out = np.zeros(nx * ny * nz, np.float32)
        lib.beamformer_set_global_timeout(120000)
        t0 = time.perf_counter()
        for k, raw in enumerate(frames):
            if not lib.beamformer_push_data_with_compute(
                    raw.ctypes.data_as(ct.c_void_p), raw.nbytes, 0, 0):
                raise PhaseFailed(lib.beamformer_get_last_error_string())
            if k == 0:
                # the first frame compiles: wait for it before timing
                if not lib.beamformer_get_last_frames(
                        out.ctypes.data_as(ct.c_void_p), out.nbytes, 1):
                    raise PhaseFailed(lib.beamformer_get_last_error_string())
                result["first_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
        if not lib.beamformer_get_last_frames(
                out.ctypes.data_as(ct.c_void_p), out.nbytes, 1):
            raise PhaseFailed(lib.beamformer_get_last_error_string())
        result["ms"] = (time.perf_counter() - t0) / (len(frames) - 1) * 1e3
        result["frame"] = out

    errors = []

    def run():
        try:
            client()
        except BaseException as e:      # reported by the main thread
            errors.append(e)

    thread = threading.Thread(target=run, name="shm-client")
    try:
        thread.start()
        thread.join(600)
        if thread.is_alive():
            raise PhaseFailed("server: client thread did not finish")
        if errors:
            raise errors[0]
    finally:
        server.stop()
    # exported frames are x-fastest (das.glsl:130-134)
    ref = expected.transpose(2, 1, 0).ravel()
    report("server/forces",
           [("vs_beamformer", nrmse(ref, result["frame"]), 1e-6)],
           compile_first_frame_s=result["first_s"], ms_per_frame=result["ms"],
           frames=len(frames), peak_bytes=peak_bytes())


def phase_four(device):
    """uFORCES 128^3 channel-sharded over four cards vs one card."""
    from ogl_beamforming_tpu.parallel.sharding import make_mesh
    if device["count"] < 4:
        raise PhaseFailed(f"--four needs 4 GPUs, JAX finds {device['count']}")
    p, pipe, sparse = presets.uforces_volumetric()
    frames = raw_frames(p, pipe.data_kind, FRAMES + 1)
    one = make_beamformer(p, pipe, {}, sparse)
    first1, ms1, ref = run_frames(one, frames)
    four = make_beamformer(p, pipe, {}, sparse,
                           mesh=make_mesh(jax.devices()[:4]))
    first4, ms4, out = run_frames(four, frames)
    report("four/uforces_channel_sharded",
           [("sharded_vs_one_card", nrmse(ref, out), 1e-5)],
           one_card_compile_first_frame_s=first1, one_card_ms_per_frame=ms1,
           four_card_compile_first_frame_s=first4, four_card_ms_per_frame=ms4,
           peak_bytes_card0=peak_bytes())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the channel-sharded path on four cards")
    args = ap.parse_args()

    device = require_gpu()
    enable_compile_cache()
    print(f"phase device: {gpu_name_and_power_limit()} | jax {device}",
          flush=True)
    if args.four:
        phase_four(device)
    else:
        expected = {}
        for name, (p, pipe, filters, sparse) in _presets():
            expected[name] = (p, pipe) + phase_beamformer(
                name, p, pipe, filters, sparse)
        phase_streaming(*expected["plane_wave"])
        phase_server(*expected["forces"])
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
