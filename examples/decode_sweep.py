"""Hadamard-decode benchmark sweep — the reference's tests/decode.c.

Per transmit count in the reference's sweep list (tests/decode.c:17-19),
decodes 4096 samples x 256 raw channels of Int16 with a realistic channel
mapping and prints the per-frame average over 32 frames in the same format:

    decode  96 | 32F Average:    1.234 [ms]

Usage: PYTHONPATH=.:$PYTHONPATH python examples/decode_sweep.py [--warmup N]
       [--transmits 16,64,96] [--dump DIR]
"""

import argparse
import json
import time

import numpy as np

AVERAGE_SAMPLES = 32            # stats-table depth (tests/decode.c)
TRANSMIT_COUNTS = [2, 4, 8, 12, 16, 20, 24, 32, 40, 48, 64, 80, 96, 128,
                   160, 192, 256]
SAMPLE_COUNT = 4096
CHANNEL_COUNT = 256


def shuffled_channel_mapping(n: int) -> np.ndarray:
    """A realistic scatter permutation (tests/decode.c:204-222 uses the
    Verasonics ordering; any fixed permutation exercises the same path)."""
    rng = np.random.default_rng(0xC0FFEE)
    return rng.permutation(n).astype(np.int16)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--transmits", type=str, default="")
    ap.add_argument("--dump", type=str, default="")
    ap.add_argument("--once", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from ogl_beamforming_tpu.ops.decode import decode_hadamard, hadamard_matrix
    from ogl_beamforming_tpu.runtime.upload import prepare_rf
    from ogl_beamforming_tpu.utils.device import enable_compile_cache

    enable_compile_cache()

    transmits = ([int(t) for t in args.transmits.split(",") if t]
                 or TRANSMIT_COUNTS)
    mapping = shuffled_channel_mapping(CHANNEL_COUNT)
    dump = {}

    for t in transmits:
        raw = np.random.randint(
            -2048, 2048, (CHANNEL_COUNT, SAMPLE_COUNT * t), dtype=np.int16)
        rf = prepare_rf(raw, mapping, CHANNEL_COUNT, t, SAMPLE_COUNT)
        rf_dev = jnp.asarray(rf)
        h = hadamard_matrix(t)
        for _ in range(args.warmup):
            jax.block_until_ready(decode_hadamard(rf_dev, h))
        t0 = time.perf_counter()
        for _ in range(AVERAGE_SAMPLES):
            out = decode_hadamard(rf_dev, h)
        jax.block_until_ready(out)
        avg_ms = (time.perf_counter() - t0) / AVERAGE_SAMPLES * 1e3
        gbs = SAMPLE_COUNT * t * CHANNEL_COUNT * 2 / (avg_ms * 1e-3) / 1e9
        print(f"decode {t:3d} | {AVERAGE_SAMPLES}F Average: {avg_ms:8.3f} "
              f"[ms] | {gbs:7.1f} GB/s")
        dump[t] = {"ms": avg_ms, "GB/s": gbs}
        if args.once:
            break

    if args.dump:
        from pathlib import Path
        out_dir = Path(args.dump)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "decode_sweep.json").write_text(json.dumps(dump, indent=1))


if __name__ == "__main__":
    main()
