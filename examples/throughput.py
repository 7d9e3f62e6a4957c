"""End-to-end throughput benchmark — the reference's tests/throughput.c.

Loads a ``.zbp`` dataset (or synthesizes one with --synthetic), builds the
[Demodulate?] -> Decode -> DAS pipeline with the filter chosen from the
emission descriptor (tests/throughput.c:455-491), beamforms onto the
512 x 1024 grid (lateral +-60 mm, axial 10-165 mm, f# = 0.5, cubic —
tests/throughput.c:20-23,450-451) and prints per-frame time, the 32-frame
rolling average, and GB/s of raw RF exactly like the reference's --loop
output (tests/throughput.c:536-556).

Usage:
  PYTHONPATH=.:$PYTHONPATH python examples/throughput.py data.zbp --loop
  PYTHONPATH=.:$PYTHONPATH python examples/throughput.py --synthetic --frames 8
"""

import argparse
import time

import jax
import numpy as np


def synthesize_zbp(c=128, a=64, s=2048):
    from ogl_beamforming_tpu.params.enums import (AcquisitionKind, DataKind,
                                                  DecodeMode)
    from ogl_beamforming_tpu.utils.zbp import ZbpFile
    rng = np.random.default_rng(3)
    return ZbpFile(
        version=(1, 0), raw_data_dimension=(a * s, c, 1, 1),
        data_kind=DataKind.Int16, decode_mode=DecodeMode.Hadamard,
        sampling_mode=0, sampling_frequency=40e6,
        demodulation_frequency=7.8e6, speed_of_sound=1540.0,
        sample_count=s, channel_count=c, receive_event_count=a,
        xdc_transform=np.eye(4, dtype=np.float32),
        xdc_element_pitch=np.array([2e-4, 2e-4], np.float32),
        time_offset=0.0, acquisition_kind=AcquisitionKind.FORCES,
        channel_mapping=np.arange(c, dtype=np.int16),
        data=rng.integers(-2048, 2048, c * a * s).astype(np.int16))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", nargs="?", help=".zbp file")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--no-demodulate", action="store_true")
    args = ap.parse_args()

    from ogl_beamforming_tpu.models.presets import from_zbp
    from ogl_beamforming_tpu.params.enums import (EmissionKind, FilterKind,
                                                  ShaderKind)
    from ogl_beamforming_tpu.params.types import (FilterParameters,
                                                  KaiserFilterParameters,
                                                  MatchedChirpFilterParameters)
    from ogl_beamforming_tpu.pipeline.executor import Beamformer
    from ogl_beamforming_tpu.utils.device import enable_compile_cache
    from ogl_beamforming_tpu.utils.zbp import load_zbp

    enable_compile_cache()

    if args.synthetic:
        z = synthesize_zbp()
    elif not args.dataset:
        # default to the committed golden fixture (known point targets)
        import pathlib
        fixture = (pathlib.Path(__file__).parent.parent / "tests" / "data"
                   / "point_targets.zbp")
        z = load_zbp(fixture) if fixture.exists() else synthesize_zbp()
    else:
        z = load_zbp(args.dataset)

    params, pipe = from_zbp(z)
    if args.no_demodulate:
        stages = [s for s in pipe.shaders if s != ShaderKind.Demodulate]
        from ogl_beamforming_tpu.pipeline.spec import PipelineSpec
        pipe = PipelineSpec.from_shaders(stages, pipe.data_kind)

    bf = Beamformer()
    bf.push_parameters(params)
    bf.push_pipeline(pipe.shaders, pipe.data_kind)
    if z.channel_mapping is not None:
        bf.push_channel_mapping(z.channel_mapping)
    if z.sparse_elements is not None:
        bf.push_sparse_elements(z.sparse_elements)

    # Filter from the emission descriptor (tests/throughput.c:463-491).
    if any(s == ShaderKind.Demodulate for s in pipe.shaders):
        em = z.emissions[0] if z.emissions else {"kind": 0}
        if em.get("kind") == int(EmissionKind.Chirp):
            fp = FilterParameters(
                kind=FilterKind.MatchedChirp,
                sampling_frequency=z.sampling_frequency, complex=True,
                matched_chirp=MatchedChirpFilterParameters(
                    em.get("duration", 2e-6), em.get("min_frequency", 2e6),
                    em.get("max_frequency", 8e6)))
        else:
            fp = FilterParameters(
                kind=FilterKind.Kaiser,
                sampling_frequency=z.sampling_frequency,
                kaiser=KaiserFilterParameters(
                    z.demodulation_frequency or z.sampling_frequency / 4,
                    4.0, 36))
        bf.create_filter(fp, filter_slot=0)

    raw = z.data[: z.channel_count * z.receive_event_count * z.sample_count
                 ].reshape(z.channel_count, -1)
    raw_bytes = raw.nbytes

    times = []
    n = 10 ** 9 if args.loop else args.frames
    for i in range(n):
        t0 = time.perf_counter()
        frame = bf.push_data_with_compute(raw)
        jax.block_until_ready(frame.data)
        dt = time.perf_counter() - t0
        times.append(dt)
        window = times[-32:]
        avg = sum(window) / len(window)
        print(f"Frame Time: {dt * 1e3:8.3f} [ms] | 32-Frame Average: "
              f"{avg * 1e3:8.3f} [ms] | {raw_bytes / avg / 1e9:5.2f} GB/s",
              flush=True)


if __name__ == "__main__":
    main()
