"""End-to-end demo: synthetic FORCES point scatterer -> GPU beamform -> PNG.

Run from the repo root:

    PYTHONPATH=.:$PYTHONPATH python examples/point_scatterer.py
"""

import time

import jax
import numpy as np

import ogl_beamforming_tpu as bft
from ogl_beamforming_tpu import viewer
from ogl_beamforming_tpu.params.enums import ShaderKind
from ogl_beamforming_tpu.pipeline.executor import Beamformer
from ogl_beamforming_tpu.utils.device import enable_compile_cache
from ogl_beamforming_tpu.utils.hadamard import hadamard
from ogl_beamforming_tpu.utils.transforms import das_transform_2d_xz


def synthesize_forces_frame(c, a, s, fs, sos, pitch, target, f0):
    """Per-(channel, transmit) echoes for a point target, Hadamard-encoded
    across transmits as the scanner records them."""
    rx_x = np.arange(c) * pitch
    tx_x = np.arange(a) * pitch
    ty = target[1] - pitch * c / 2
    rx_d = np.sqrt((target[0] - rx_x) ** 2 + target[2] ** 2)
    tx_d = np.sqrt(ty ** 2 + target[2] ** 2 + (target[0] - tx_x) ** 2)
    dist = rx_d[:, None] + tx_d[None, :]
    t = np.arange(s) / fs
    arg = t[None, None, :] - dist[:, :, None] / sos
    env = np.exp(-0.5 * (arg / (2 / f0 / 4)) ** 2)
    echo = (env * np.sin(2 * np.pi * f0 * arg)).astype(np.float32)
    encoded = np.einsum("tj,cts->cjs", hadamard(a), echo)
    return np.clip(encoded * 2000, -32768, 32767).astype(np.int16)


def main():
    enable_compile_cache()
    print("devices:", jax.devices())
    c, a, s = 64, 32, 2048
    fs, sos, pitch, f0 = 20e6, 1500.0, 0.3e-3, 5e6
    target = np.array([(c // 2) * pitch, 0.0, 8e-3])

    p = bft.Parameters(
        sample_count=s, channel_count=c, acquisition_count=a,
        sampling_frequency=fs, demodulation_frequency=f0,
        speed_of_sound=sos, f_number=1.0,
        acquisition_kind=bft.AcquisitionKind.FORCES,
        interpolation_mode=bft.InterpolationMode.Cubic,
        das_voxel_transform=das_transform_2d_xz(
            [0, 2e-3], [(c - 1) * pitch, 16e-3]),
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        output_points=np.array([256, 512, 1, 0], np.int32))

    bf = Beamformer()
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS],
                     bft.DataKind.Int16)

    raw = synthesize_forces_frame(c, a, s, fs, sos, pitch, target, f0)
    raw = raw.reshape(c, a * s)

    t0 = time.perf_counter()
    frame = bf.push_data_with_compute(raw)
    print(f"first frame (incl. compile): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    frame = bf.push_data_with_compute(raw)
    print(f"steady-state frame: {(time.perf_counter() - t0) * 1e3:.1f} ms")

    img = viewer.bmode_image(frame, db_cutoff=-50)
    iz, ix = np.unravel_index(np.argmax(img), img.shape)
    wx = ix / 255 * (c - 1) * pitch
    wz = 2e-3 + iz / 511 * 14e-3
    print(f"image peak at ({wx * 1e3:.2f}, {wz * 1e3:.2f}) mm; "
          f"target ({target[0] * 1e3:.2f}, {target[2] * 1e3:.2f}) mm")

    out = viewer.save_bmode_png(
        frame, "point_scatterer.png", db_cutoff=-50,
        extent_mm=[0, (c - 1) * pitch * 1e3, 2, 16],
        title="FORCES point scatterer")
    print("wrote", out)


if __name__ == "__main__":
    main()
