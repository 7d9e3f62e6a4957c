"""Live streaming demo: continuous ingest + browser view.

Simulates a scanner streaming FORCES frames of a moving point target into a
:class:`StreamingSession` while a browser LiveView serves the B-mode image,
compute stats, and live controls at http://localhost:8765/ — the
equivalent of the reference's live-imaging UI loop.

    PYTHONPATH=.:$PYTHONPATH python examples/live_streaming.py [--frames 100]
"""

import argparse
import time

import numpy as np

import ogl_beamforming_tpu as bft
from ogl_beamforming_tpu.params.enums import LiveImagingDirtyFlags, ShaderKind
from ogl_beamforming_tpu.pipeline.executor import Beamformer
from ogl_beamforming_tpu.runtime.streaming import StreamingSession
from ogl_beamforming_tpu.utils.device import enable_compile_cache
from ogl_beamforming_tpu.utils.hadamard import hadamard
from ogl_beamforming_tpu.utils.transforms import das_transform_2d_xz
from ogl_beamforming_tpu.viewer_web import LiveView

C, A, S = 32, 16, 1024
FS, SOS, PITCH, F0 = 10e6, 1500.0, 0.3e-3, 2.5e6


def frame_for_target(target):
    rx_x = np.arange(C) * PITCH
    tx_x = np.arange(A) * PITCH
    ty = -PITCH * C / 2
    rx_d = np.sqrt((target[0] - rx_x) ** 2 + target[2] ** 2)
    tx_d = np.sqrt(ty ** 2 + target[2] ** 2 + (target[0] - tx_x) ** 2)
    dist = (rx_d[:, None] + tx_d[None, :]).reshape(-1)
    t = np.arange(S) / FS
    arg = t[None, :] - dist[:, None] / SOS
    env = np.exp(-0.5 * (arg / (2 / F0 / 4)) ** 2)
    echo = (env * np.sin(2 * np.pi * F0 * arg)).reshape(C, A, S)
    enc = np.einsum("tj,cts->cjs", hadamard(A), echo)
    return np.clip(enc * 2000, -32768, 32767).astype(np.int16).reshape(C, -1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--port", type=int, default=8765)
    args = ap.parse_args()
    enable_compile_cache()

    p = bft.Parameters(
        sample_count=S, channel_count=C, acquisition_count=A,
        sampling_frequency=FS, demodulation_frequency=F0,
        speed_of_sound=SOS, f_number=1.0,
        acquisition_kind=bft.AcquisitionKind.FORCES,
        interpolation_mode=bft.InterpolationMode.Cubic,
        das_voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                [(C - 1) * PITCH, 8e-3]),
        xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
        output_points=np.array([128, 256, 1, 0], np.int32))

    bf = Beamformer()
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], bft.DataKind.Int16)

    view = LiveView(bf, port=args.port).start()
    print(f"live view at {view.url}")

    with StreamingSession(bf) as stream:
        handle = None
        for i in range(args.frames):
            # target orbits the image center
            phase = i / 30 * 2 * np.pi
            target = np.array([
                (C / 2 + 6 * np.cos(phase)) * PITCH, 0.0,
                4e-3 + 1.5e-3 * np.sin(phase)])
            handle = stream.submit(frame_for_target(target))
            # honor the live StopImaging control (throughput.c:558-560)
            flag = bf.live_parameters_get_dirty_flag()
            if flag >= 0 and (1 << flag) & LiveImagingDirtyFlags.StopImaging:
                print("stop requested")
                break
            if i % 10 == 0 and handle.done():
                print(f"frame {i}: "
                      f"{bf.stats.average_frame_time() * 1e3:.1f} ms avg")
        if handle:
            handle.result(timeout=60)
    print("done; view stays up 30 s")
    time.sleep(30)
    view.stop()


if __name__ == "__main__":
    main()
