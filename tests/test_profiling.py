"""Device-side profiling: trace parsing and the executor integration
(utils/profiling.py — the reference's per-dispatch GPU timestamps,
vulkan.c:2616-2637).  Device times exist only on the GPU, so the parser is
checked against a trace recorded on the card (tests/data/
make_gpu_trace.py) and a synthetic one; on the CPU, asking for device time
is an error."""

import os

import jax
import numpy as np
import pytest

from ogl_beamforming_tpu.params.enums import DataKind, ShaderKind
from ogl_beamforming_tpu.pipeline.executor import Beamformer
from ogl_beamforming_tpu.utils.profiling import (DeviceProfile, device_time,
                                                 parse_xplane)

from test_pipeline import _make_params

GPU_TRACE = os.path.join(os.path.dirname(__file__), "data",
                         "gpu_trace.xplane.pb")

# Two streams of one device: a kernel overlapping a copy, then a second
# kernel; plus a host plane that must be ignored.
_SYNTHETIC = """
planes {
  id: 1 name: "/device:GPU:0"
  lines { id: 1 name: "Stream #13(Compute)" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 100000 }
    events { metadata_id: 2 offset_ps: 200000 duration_ps: 50000 }
    events { metadata_id: 2 offset_ps: 300000 duration_ps: 50000 }
  }
  lines { id: 2 name: "Stream #14(MemcpyH2D)" timestamp_ns: 1000
    events { metadata_id: 3 offset_ps: 50000 duration_ps: 100000 }
  }
  event_metadata { key: 1 value { id: 1 name: "das_forces" } }
  event_metadata { key: 2 value { id: 2 name: "loop_fusion" } }
  event_metadata { key: 3 value { id: 3 name: "MemcpyH2D" } }
}
planes {
  id: 2 name: "/host:CPU"
  lines { id: 1 name: "python" timestamp_ns: 0
    events { metadata_id: 1 offset_ps: 0 duration_ps: 9000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "host_noise" } }
}
"""


def test_parse_trace_sums_device_modules_and_ops(tmp_path):
    """The trace recorded on the card: the DAS kernel's event carries its
    ``name=`` and busy time is the union of the device's events."""
    prof = parse_xplane(GPU_TRACE)
    assert isinstance(prof, DeviceProfile)
    assert "das_forces" in prof.op_seconds
    assert prof.op_seconds["das_forces"] > 0
    assert 0 < prof.busy_seconds <= sum(prof.op_seconds.values()) + 1e-12
    assert prof.top_ops[0][1] == max(prof.op_seconds.values())


def test_busy_time_is_union_of_device_events(tmp_path):
    path = tmp_path / "synthetic.xplane.pb"
    path.write_bytes(jax.profiler.ProfileData.text_proto_to_serialized_xspace(
        _SYNTHETIC))
    prof = parse_xplane(str(path))
    # [0, 150) ns overlapped kernel + copy, then [200, 250) and [300, 350)
    assert abs(prof.busy_seconds - 250e-9) < 1e-15
    assert abs(prof.op_seconds["loop_fusion"] - 100e-9) < 1e-15
    assert abs(prof.op_seconds["das_forces"] - 100e-9) < 1e-15
    assert "host_noise" not in prof.op_seconds


def test_device_time_runs_on_cpu(rng):
    """A CPU trace has no GPU plane: device time is an error there, never
    a wall-clock stand-in."""
    import jax.numpy as jnp
    fn = jax.jit(lambda x: jnp.sum(x * 2.0))
    with pytest.raises(RuntimeError, match="no GPU device events"):
        device_time(fn, jnp.ones((64, 64)))


def test_device_stage_timing_falls_back_on_cpu(rng):
    """On the CPU the fused path's stage calibration times each stage by
    the wall clock: stats stay nonzero for every stage."""
    c, a, s = 8, 4, 256
    bf = Beamformer(voxel_block=128)
    bf.push_parameters(_make_params(c, a, s))
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    raw = rng.integers(-512, 512, (c, a * s)).astype(np.int16)
    bf.push_data_with_compute(raw)
    row = (bf.stats._frame_index - 1) % 32
    times = [bf.stats.table.times[row, i] for i in range(2)]
    assert all(t > 0 for t in times)


def test_profile_device_stages_cpu_fallback(rng):
    """Per-stage device profiling needs the card: on the CPU it raises
    and records nothing."""
    c, a, s = 8, 4, 256
    bf = Beamformer(voxel_block=128)
    bf.push_parameters(_make_params(c, a, s))
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    rf = rng.integers(-512, 512, (c, a, s)).astype(np.int16)
    with pytest.raises(RuntimeError, match="no GPU device events"):
        bf.profile_device_stages(rf, record=True)
    assert bf.stats._frame_index == 0
