"""Benchmark driver: decode + DAS throughput on the GPU.

Reproduces the reference's measurement methodology (BASELINE.md):
  * decode sweep (tests/decode.c): ms/frame + GB/s per transmit count
  * end-to-end decode->DAS chain (tests/throughput.c): frames/s and the
    north-star voxels*channels/s

Prints ONE JSON line naming the device (platform, kind, count and the
card's power limit):
  {"metric": ..., "value": N, "unit": ..., "device": {...}, ...}

Times are host-clock milliseconds around calls that end in
``block_until_ready``, after a warm-up call; the decode sweep also reads
device time from a profiler trace.
"""

import argparse
import json
import os
import sys
import threading
import time

import numpy as np


def _progress(msg):
    """Liveness/progress to stderr (stdout stays the one JSON line)."""
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


# A watchdog prints the best-known result and exits when the wall-clock
# budget expires, so a run cut short still leaves one parseable line.
WATCHDOG_S = float(os.environ.get("BENCH_WATCHDOG_S", "520"))

_STATE = {"stage": "init", "result": None, "emitted": False,
          "lock": threading.Lock()}


def _emit_and_exit(obj, code=0):
    """Print the one JSON line exactly once (watchdog/main race-safe) and
    hard-exit (os._exit: the main thread may be blocked in native code)."""
    with _STATE["lock"]:
        if _STATE["emitted"]:
            return
        _STATE["emitted"] = True
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()
    os._exit(code)


def _error_result(msg):
    return {"metric": "DAS voxels*channels/s (unavailable)", "value": 0,
            "unit": "voxel*channel/s", "error": msg[:400]}


def _watchdog_fire():
    res = _STATE["result"]
    if res is None:
        res = _error_result(
            f"watchdog: {WATCHDOG_S:.0f}s budget exceeded at stage "
            f"'{_STATE['stage']}' before the headline completed")
    else:
        res = dict(res)
        res["watchdog_timeout_stage"] = _STATE["stage"]
    _progress(f"WATCHDOG fired at stage '{_STATE['stage']}' — emitting "
              "best-known result")
    _emit_and_exit(res, 0 if _STATE["result"] is not None else 1)


def _start_watchdog():
    t = threading.Timer(WATCHDOG_S, _watchdog_fire)
    t.daemon = True
    t.start()
    return t


def _timeit(fn, warmup=1, iters=8):
    """Median seconds per call, each call waited for with
    ``block_until_ready``, after ``warmup`` untimed calls."""
    import jax
    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _rf_int16(shape, seed=0):
    """Raw RF over the full int16 range, as scanners deliver it."""
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, shape, dtype=np.int16)


# tests/decode.c:17-19 sweeps this exact transmit set, including the
# non-power-of-2 12/20-seed Kronecker orders (12,20,24,40,48,80,160,192).
DECODE_SWEEP_FULL = (2, 4, 8, 12, 16, 20, 24, 32, 40, 48, 64, 80, 96, 128,
                     160, 192, 256)


def bench_decode(c=256, s=4096, transmits=(16, 64, 96, 256), iters=100):
    """tests/decode.c sweep: 4096 samples x 256 channels Int16.

    ``ms`` is the host-clock time per call; ``dev_ms`` the device busy
    time from a jax.profiler trace — the number comparable to the
    reference's GPU-timestamp averages (tests/decode.c:239-250) — and
    ``GB/s`` (int16 in, f32 out) is computed from it."""
    import jax.numpy as jnp
    from ogl_beamforming_tpu.ops.decode import decode_hadamard, hadamard_matrix
    from ogl_beamforming_tpu.utils.profiling import device_time

    results = {}
    for t in transmits:
        rf = jnp.asarray(_rf_int16((c, t, s), seed=t))
        h = hadamard_matrix(t)
        dt = _timeit(lambda: decode_hadamard(rf, h), warmup=2,
                     iters=max(8, iters * 16 // max(t, 16)))
        dev = device_time(lambda: decode_hadamard(rf, h)).busy_seconds
        row = {"ms": dt * 1e3, "dev_ms": dev * 1e3,
               "GB/s": s * t * c * (2 + 4) / dev / 1e9}
        results[t] = row
    return {"per_transmit": results,
            "config": f"C={c} S={s} int16 Hadamard decode"}


def bench_das_chain(c=128, a=16, s=2048, nx=256, nz=512, iters=32,
                    voxel_block=32768):
    """Multi-transmit decode -> DAS chain (FORCES compounding)."""
    import jax.numpy as jnp
    from ogl_beamforming_tpu.params.enums import (AcquisitionKind, DataKind,
                                                  InterpolationMode,
                                                  ShaderKind)
    from ogl_beamforming_tpu.params.types import Parameters
    from ogl_beamforming_tpu.pipeline.plan import build_plan
    from ogl_beamforming_tpu.pipeline.spec import PipelineSpec
    from ogl_beamforming_tpu.utils.transforms import das_transform_2d_xz

    pitch = 0.3e-3
    p = Parameters(
        sample_count=s, channel_count=c, acquisition_count=a,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, f_number=0.5,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Cubic,
        das_voxel_transform=das_transform_2d_xz([-0.06, 0.01], [0.06, 0.165]),
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        output_points=np.array([nx, nz, 1, 0], np.int32))
    plan = build_plan(
        p, PipelineSpec.from_shaders([ShaderKind.Decode, ShaderKind.DAS],
                                     DataKind.Int16),
        {}, voxel_block=voxel_block)
    rf = jnp.asarray(_rf_int16((c, a, s)))
    dt = _timeit(lambda: plan(rf), warmup=2, iters=iters)
    voxels = nx * nz
    return {
        "ms_per_frame": dt * 1e3,
        "fps": 1.0 / dt,
        "voxch_per_s": voxels * c / dt,
        "raw_GBps": c * a * s * 2 / dt / 1e9,
        "config": f"C={c} A={a} S={s} out={nx}x{nz} cubic int16",
    }


def bench_plane_wave(c=256, s=4096, nx=512, nz=1024, iters=32):
    """2D plane-wave DAS on the throughput.c output grid (BASELINE config 2:
    512x1024 voxels, lateral +-60 mm, axial 10-165 mm, f# = 0.5, cubic IQ).

    32-frame medians, matching the reference's stats window
    (tests/decode.c AVERAGE_SAMPLES).
    """
    import jax.numpy as jnp
    from ogl_beamforming_tpu.models.presets import plane_wave_2d
    from ogl_beamforming_tpu.params.enums import DataKind
    from ogl_beamforming_tpu.pipeline.plan import build_plan

    # The client-expressible IQ configuration: Float32Complex wire data
    # (interleaved I/Q scalars), decode_mode=NoDecode — the planner strips
    # the Decode stage and DAS runs complex baseband.  No manual static or
    # table surgery: the number below is plan(rf) end to end.
    p, pipe = plane_wave_2d(channel_count=c, sample_count=s,
                            output_points=(nx, nz),
                            data_kind=DataKind.Float32Complex)
    plan = build_plan(p, pipe, {})
    rf = jnp.asarray(np.random.default_rng(0).standard_normal(
        (c, 1, 2 * s), np.float32))
    dt = _timeit(lambda: plan(rf), warmup=2, iters=iters)
    voxels = nx * nz
    return {
        "ms_per_frame": dt * 1e3,
        "fps": 1.0 / dt,
        "voxch_per_s": voxels * c / dt,
        "config": f"plane-wave C={c} S={s} out={nx}x{nz} cubic IQ",
    }


def bench_plane_wave_batched(B=4, c=256, s=4096, nx=512, nz=1024, iters=8):
    """Frame-batched headline: B frames per device program — the
    throughput mode for offline datasets and frame averaging (the
    reference's sum.glsl / output_points.w path).  Reported per frame."""
    import jax.numpy as jnp
    from ogl_beamforming_tpu.models.presets import plane_wave_2d
    from ogl_beamforming_tpu.params.enums import DataKind
    from ogl_beamforming_tpu.pipeline.plan import build_plan

    p, pipe = plane_wave_2d(channel_count=c, sample_count=s,
                            output_points=(nx, nz),
                            data_kind=DataKind.Float32Complex)
    plan = build_plan(p, pipe, {}, frame_batch=B)
    rf = jnp.asarray(np.random.default_rng(0).standard_normal(
        (B, c, 1, 2 * s), np.float32))
    dt = _timeit(lambda: plan(rf), warmup=2, iters=iters) / B
    voxels = nx * nz
    return {
        "ms_per_frame": dt * 1e3,
        "fps": 1.0 / dt,
        "voxch_per_s": voxels * c / dt,
        "config": f"plane-wave C={c} S={s} out={nx}x{nz} cubic IQ "
                  f"frame_batch={B}",
    }


def bench_demod_chain(c=128, a=16, s=2048, nx=256, nz=512, iters=32):
    """Full Demodulate -> Decode -> DAS chain on Int16 RF — the exact
    tests/throughput.c pipeline (:455-461) with a Kaiser baseband filter;
    the decode stage runs on complex baseband."""
    import jax.numpy as jnp
    from ogl_beamforming_tpu.models.presets import forces_compounding
    from ogl_beamforming_tpu.params.enums import (FilterKind, ShaderKind)
    from ogl_beamforming_tpu.params.types import (FilterParameters,
                                                  KaiserFilterParameters)
    from ogl_beamforming_tpu.pipeline.plan import build_plan
    from ogl_beamforming_tpu.utils.filters import make_filter

    p, pipe = forces_compounding(channel_count=c, transmit_count=a,
                                 sample_count=s, sampling_frequency=20e6,
                                 demodulation_frequency=5e6,
                                 output_points=(nx, nz), demodulate=True)
    fp = FilterParameters(kind=FilterKind.Kaiser, sampling_frequency=20e6,
                          kaiser=KaiserFilterParameters(2e6, 4.0, 16))
    plan = build_plan(p, pipe, {0: make_filter(fp)})
    rf = jnp.asarray(_rf_int16((c, a, s)))
    dt = _timeit(lambda: plan(rf), warmup=2, iters=iters)
    voxels = nx * nz
    return {
        "ms_per_frame": dt * 1e3,
        "fps": 1.0 / dt,
        "voxch_per_s": voxels * c / dt,
        "raw_GBps": c * a * s * 2 / dt / 1e9,
        "config": f"demod->decode->DAS C={c} A={a} S={s} out={nx}x{nz}"
                  " cubic IQ int16",
    }


def bench_hercules(iters=3):
    """HERCULES 3D volume (96^3, 128 ch x 128 tx, linear)."""
    import jax.numpy as jnp
    from ogl_beamforming_tpu.models.presets import hercules_3d
    from ogl_beamforming_tpu.pipeline.plan import build_plan

    p, pipe = hercules_3d()
    plan = build_plan(p, pipe, {})
    rf = jnp.asarray(_rf_int16((128, 128, 2048)))
    dt = _timeit(lambda: plan(rf), warmup=1, iters=iters)
    return {"ms_per_frame": dt * 1e3,
            "voxch_per_s": 96 ** 3 * 128 / dt,
            "config": "HERCULES 96^3 C=A=128 linear int16"}


def bench_uforces_3d(iters=2):
    """3D volumetric sparse uFORCES with coherency weighting (BASELINE
    config 4): decode over 64 acquisitions, DAS over the 63 sparse
    transmits, 128^3 output."""
    import jax.numpy as jnp
    from ogl_beamforming_tpu.models.presets import uforces_volumetric
    from ogl_beamforming_tpu.pipeline.plan import build_plan

    p, pipe, sparse = uforces_volumetric()
    plan = build_plan(p, pipe, {}, sparse_elements=sparse)
    c, a, s = 256, 64, 2048
    rf = jnp.asarray(_rf_int16((c, a, s)))
    dt = _timeit(lambda: plan(rf), warmup=1, iters=iters)
    return {"ms_per_frame": dt * 1e3,
            "voxch_per_s": 128 ** 3 * c / dt,
            "config": "uFORCES 128^3 C=256 A=64 sparse + coherency"}


def bench_forces_big(iters=8):
    """FORCES compounding on the full 512x1024 grid (linear)."""
    import jax.numpy as jnp
    from ogl_beamforming_tpu.params.enums import (AcquisitionKind, DataKind,
                                                  InterpolationMode,
                                                  ShaderKind)
    from ogl_beamforming_tpu.params.types import Parameters
    from ogl_beamforming_tpu.pipeline.plan import build_plan
    from ogl_beamforming_tpu.pipeline.spec import PipelineSpec
    from ogl_beamforming_tpu.utils.transforms import das_transform_2d_xz

    pitch = 0.3e-3
    c, a, s, nx, nz = 256, 16, 2048, 512, 1024
    p = Parameters(
        sample_count=s, channel_count=c, acquisition_count=a,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, f_number=0.5,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Linear,
        das_voxel_transform=das_transform_2d_xz([-0.06, 0.01], [0.06, 0.165]),
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        output_points=np.array([nx, nz, 1, 0], np.int32))
    plan = build_plan(p, PipelineSpec.from_shaders(
        [ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16), {})
    rf = jnp.asarray(_rf_int16((c, a, s)))
    dt = _timeit(lambda: plan(rf), warmup=1, iters=iters)
    return {"ms_per_frame": dt * 1e3,
            "voxch_per_s": nx * nz * c / dt,
            "config": f"FORCES C={c} A={a} S={s} out={nx}x{nz} linear"}


def numerics_canary():
    """Small FORCES cubic-IQ frame through the default DAS backend vs the
    NumPy golden oracle, on the device.  Timing numbers are meaningless if
    the kernel is wrong; main() flags a canary above the 1e-3 golden
    contract so a regression is never recorded as throughput."""
    import dataclasses

    import jax

    from ogl_beamforming_tpu.ops import golden
    from ogl_beamforming_tpu.ops.das import das_jit, make_dynamic, make_static
    from ogl_beamforming_tpu.params.enums import (AcquisitionKind,
                                                  InterpolationMode)
    from ogl_beamforming_tpu.pipeline.plan import resolve_das_backend
    from ogl_beamforming_tpu.utils.transforms import das_transform_2d_xz

    rng = np.random.default_rng(7)
    c, a, s = 32, 8, 512
    pitch = 0.3e-3
    dp = golden.DasParams(
        acquisition_kind=AcquisitionKind.FORCES, acquisition_count=a,
        channel_count=c, sample_count=s, sampling_frequency=10e6,
        demodulation_frequency=5e6, speed_of_sound=1500.0,
        interpolation_mode=InterpolationMode.Cubic, f_number=0.8,
        voxel_transform=np.asarray(
            das_transform_2d_xz([0, 1e-3], [(c - 1) * pitch, 12e-3])),
        xdc_element_pitch=np.asarray([pitch, pitch], np.float32),
        output_points=(64, 128, 1))
    re = rng.standard_normal((c, a, s)).astype(np.float32)
    im = rng.standard_normal((c, a, s)).astype(np.float32)
    ref = golden.das(re + 1j * im, dp)
    st = make_static(dp, iq=True)
    st = dataclasses.replace(st, backend=resolve_das_backend(st))
    rf = jax.jit(lambda x, y: jax.lax.complex(x, y))(re, im)
    out = np.asarray(das_jit(rf, make_dynamic(dp), st))
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def chain_canary():
    """Small Demodulate -> Decode -> DAS chain vs golden on the device —
    guards the chain rows the DAS-only :func:`numerics_canary` cannot see
    (demodulate/FIR and complex decode)."""
    from ogl_beamforming_tpu.models.presets import forces_compounding
    from ogl_beamforming_tpu.ops import golden
    from ogl_beamforming_tpu.params.enums import FilterKind
    from ogl_beamforming_tpu.params.types import (FilterParameters,
                                                  KaiserFilterParameters)
    from ogl_beamforming_tpu.pipeline.plan import build_plan
    from ogl_beamforming_tpu.utils.filters import make_filter
    from ogl_beamforming_tpu.utils.hadamard import hadamard

    rng = np.random.default_rng(11)
    c, a, s = 16, 4, 512
    p, pipe = forces_compounding(channel_count=c, transmit_count=a,
                                 sample_count=s, sampling_frequency=20e6,
                                 demodulation_frequency=5e6,
                                 output_points=(32, 64), demodulate=True)
    fp = FilterParameters(kind=FilterKind.Kaiser, sampling_frequency=20e6,
                          kaiser=KaiserFilterParameters(2e6, 4.0, 16))
    f = make_filter(fp)
    plan = build_plan(p, pipe, {0: f})
    rf = rng.integers(-32768, 32768, (c, a, s)).astype(np.int16)
    out = np.asarray(plan(rf))

    iq = golden.demodulate(rf, f.taps, 5e6, 20e6, 1, False)
    dec = golden.decode_hadamard(iq, hadamard(a))
    from ogl_beamforming_tpu.ops.golden import DasParams
    from ogl_beamforming_tpu.params.enums import (AcquisitionKind,
                                                  InterpolationMode)
    dp = DasParams(
        acquisition_kind=AcquisitionKind.FORCES, acquisition_count=a,
        channel_count=c, sample_count=s // 2, sampling_frequency=10e6,
        demodulation_frequency=5e6,
        speed_of_sound=float(p.speed_of_sound),
        time_offset=float(p.time_offset) + f.time_delay,
        interpolation_mode=InterpolationMode.Cubic,
        f_number=float(p.f_number),
        voxel_transform=np.asarray(p.das_voxel_transform),
        xdc_element_pitch=np.asarray(p.xdc_element_pitch),
        output_points=(32, 64, 1))
    ref = golden.das(dec.astype(np.complex64), dp)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


FULL_ROWS = (
    ("plane_wave", bench_plane_wave),
    ("plane_wave_batched", bench_plane_wave_batched),
    ("decode_sweep", lambda: bench_decode(transmits=DECODE_SWEEP_FULL,
                                          iters=64)),
    ("das_chain", bench_das_chain),
    ("demod_chain", bench_demod_chain),
    ("hercules_3d", bench_hercules),
    ("forces_big", bench_forces_big),
    ("uforces_3d", bench_uforces_3d),
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="also run the decode sweep and per-family rows")
    ap.add_argument("--out", default=None,
                    help="also write the result JSON to this path, updated "
                         "after every row so a timeout still leaves the "
                         "completed rows on disk")
    args = ap.parse_args()

    def checkpoint(obj):
        if args.out:
            with open(args.out, "w") as f:
                json.dump(obj, f, indent=1)

    _start_watchdog()
    from ogl_beamforming_tpu.utils.device import (enable_compile_cache,
                                                  gpu_name_and_power_limit,
                                                  require_gpu)
    _STATE["stage"] = "device"
    try:
        device = require_gpu()
        device["nvidia_smi"] = gpu_name_and_power_limit()
    except (RuntimeError, OSError) as e:
        _emit_and_exit(_error_result(f"{type(e).__name__}: {e}"), 1)
    cache_dir = enable_compile_cache()
    _progress(f"{device} compile cache at {cache_dir} "
              f"(watchdog {WATCHDOG_S:.0f}s)")

    try:
        _run(args, device, checkpoint)
    except Exception as e:      # still one line, naming the device
        res = dict(_STATE["result"] or _error_result(""), device=device)
        res["error"] = (f"stage '{_STATE['stage']}': "
                        f"{type(e).__name__}: {e}")[:400]
        _emit_and_exit(res, 1)


def _run(args, device, checkpoint):
    _STATE["stage"] = "numerics canary (compile + run)"
    canary = numerics_canary()
    _progress(f"canary nrmse {canary:.2e}")
    _STATE["stage"] = "headline plane-wave (compile + run)"
    pw = bench_plane_wave()
    _progress(f"headline {pw['ms_per_frame']:.2f} ms/frame")
    result = {
        "metric": "DAS voxels*channels/s (" + pw["config"] + ")",
        "value": round(pw["voxch_per_s"], 1),
        "unit": "voxel*channel/s",
        "ms_per_frame": pw["ms_per_frame"],
        "device": device,
        "canary_nrmse": canary,
    }
    if not canary <= 1e-3:      # numerics broken: throughput is meaningless
        result["canary_fail"] = True
    _STATE["result"] = result
    if args.full:
        _STATE["stage"] = "chain canary"
        result["chain_canary_nrmse"] = chain_canary()
        if not result["chain_canary_nrmse"] <= 1e-3:
            result["chain_canary_fail"] = True
        checkpoint(result)
        for name, fn in FULL_ROWS:
            _STATE["stage"] = f"full row {name}"
            result[name] = fn()
            _progress(f"{name}: {result[name]}")
            checkpoint(result)
    _STATE["stage"] = "done"
    checkpoint(result)
    _emit_and_exit(result)


if __name__ == "__main__":
    main()
