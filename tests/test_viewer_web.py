"""Live web viewer: endpoints served over real HTTP."""

import json
import urllib.request

import numpy as np
import pytest

from ogl_beamforming_tpu.params.enums import (AcquisitionKind, DataKind,
                                              InterpolationMode,
                                              LiveImagingDirtyFlags,
                                              ShaderKind)
from ogl_beamforming_tpu.params.types import Parameters
from ogl_beamforming_tpu.pipeline.executor import Beamformer
from ogl_beamforming_tpu.utils.transforms import das_transform_2d_xz
from ogl_beamforming_tpu.viewer_web import LiveView, encode_png_gray


@pytest.fixture
def view(rng):
    pitch = 0.3e-3
    p = Parameters(
        sample_count=256, channel_count=8, acquisition_count=4,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, f_number=0.8,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Linear,
        das_voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                [7 * pitch, 8e-3]),
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        output_points=np.array([12, 16, 1, 0], np.int32))
    bf = Beamformer(voxel_block=128)
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    bf.push_data_with_compute(
        rng.integers(-512, 512, (8, 4 * 256)).astype(np.int16))
    v = LiveView(bf, port=0).start()
    yield v
    v.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get_content_type(), r.read()


def test_png_encoder():
    png = encode_png_gray(np.linspace(0, 1, 64 * 32).reshape(64, 32))
    assert png.startswith(b"\x89PNG")
    assert b"IHDR" in png and b"IEND" in png


def test_index_page(view):
    status, ctype, body = _get(view.url)
    assert status == 200 and ctype == "text/html"
    assert b"live view" in body


def test_frame_endpoint(view):
    status, ctype, body = _get(view.url + "frame.png?db=-50&gamma=1.2")
    assert status == 200 and ctype == "image/png"
    assert body.startswith(b"\x89PNG")


def test_stats_endpoint(view):
    status, _, body = _get(view.url + "stats.json")
    st = json.loads(body)
    names = [s["name"] for s in st["stages"]]
    assert names == ["Decode", "DAS"]
    assert st["frame_ms"] > 0


def test_live_controls(view):
    req = urllib.request.Request(
        view.url + "live", method="POST",
        data=json.dumps({"transmit_power": 0.7}).encode())
    with urllib.request.urlopen(req, timeout=10) as r:
        out = json.loads(r.read())
    assert out["ok"]
    assert view.beamformer.live_parameters.transmit_power == \
        pytest.approx(0.7)
    flags = view.beamformer.live_parameters_get_dirty_flag()
    assert flags & int(LiveImagingDirtyFlags.TransmitPower)
    # GET reflects state
    _, _, body = _get(view.url + "live")
    assert json.loads(body)["transmit_power"] == pytest.approx(0.7)


def test_xplane_render_pick_drag():
    """Software X-plane projector + raycast plane grab (ui.c:913-1068)."""
    from ogl_beamforming_tpu.viewer_xplane import (drag_plane, pick_plane,
                                                   render_xplane,
                                                   slice_volume)
    rng = np.random.default_rng(0)
    v = rng.random((16, 12, 20)).astype(np.float32)
    img = render_xplane(v, offsets=[0.0, 0.0, 0.0], yaw=0.6, pitch=0.45,
                        size=128)
    assert img.shape == (128, 128)
    assert img.max() > 0          # planes visible

    s = slice_volume(v, 2, 0.5)
    assert s.shape == (12, 16)    # transposed (ny, nx)

    # a click at the view center must grab some plane (all pass through 0)
    hit = pick_plane([0.0, 0.0, 0.0], 0.6, 0.45, 64, 64, size=128)
    assert hit is not None
    # a click far outside the volume misses
    assert pick_plane([0.0, 0.0, 0.0], 0.6, 0.45, 1, 1, size=128) is None

    # dragging moves the grabbed plane monotonically and clamps to [-1, 1]
    off = 0.0
    for _ in range(200):
        off = drag_plane([off, 0, 0], 0, 0.6, 0.45, 30.0, 0.0, size=128)
    assert -1.0 <= off <= 1.0 and off != 0.0


def test_oblique_slice_and_mip():
    """Oblique plane sampling + maximum-intensity projection."""
    from ogl_beamforming_tpu.viewer_xplane import oblique_slice, render_mip

    v = np.zeros((16, 24, 32), np.float32)
    v[8, 12, 20] = 1.0            # normalized ~ (0.067, 0.043, 0.290)
    pt = np.array([8 / 15, 12 / 23, 20 / 31]) * 2 - 1

    # a plane through the bright point contains it at the image center
    img = oblique_slice(v, center=pt, normal=[1.0, 1.0, 1.0], size=65)
    iy, ix = np.unravel_index(img.argmax(), img.shape)
    assert img.max() > 0.2
    assert abs(iy - 32) <= 2 and abs(ix - 32) <= 2
    # a parallel plane far away misses it entirely
    far = oblique_slice(v, center=[0.9, 0.9, 0.9], normal=[1.0, 1.0, 1.0],
                        size=33)
    assert far.max() < 0.05

    # MIP picks up the global max from any view angle
    for yaw, pitch in [(0.0, 0.0), (0.7, 0.4), (2.1, -0.3)]:
        mip = render_mip(v, yaw=yaw, pitch=pitch, size=96, n_steps=96)
        assert mip.max() == pytest.approx(1.0)
    # identity view: the point projects at its (x, y) screen position
    mip = render_mip(v, yaw=0.0, pitch=0.0, size=96, n_steps=96)
    iy, ix = np.unravel_index(mip.argmax(), mip.shape)
    assert abs(ix - (pt[0] * 24 + 48)) <= 2       # scale = size/4
    assert abs(iy - (pt[1] * 24 + 48)) <= 2


def test_xplane_endpoints(view):
    base = view.url.rstrip("/")
    png = urllib.request.urlopen(base + "/xplane.png?size=64").read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    png = urllib.request.urlopen(base + "/slice.png?axis=2&frac=0.5").read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    png = urllib.request.urlopen(base + "/mip.png?size=48").read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    png = urllib.request.urlopen(
        base + "/oblique.png?nx=1&ny=1&nz=0.5&size=48").read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    page = urllib.request.urlopen(base + "/xplane").read()
    assert b"x-plane" in page

    req = urllib.request.Request(
        base + "/pick", method="POST",
        data=json.dumps({"offsets": [0, 0, 0], "yaw": 0.6, "pitch": 0.45,
                         "x": 256, "y": 256}).encode())
    res = json.loads(urllib.request.urlopen(req).read())
    assert "axis" in res

    req = urllib.request.Request(
        base + "/drag", method="POST",
        data=json.dumps({"offsets": [0, 0, 0], "axis": 0, "yaw": 0.6,
                         "pitch": 0.45, "dx": 20, "dy": 0}).encode())
    res = json.loads(urllib.request.urlopen(req).read())
    assert len(res["offsets"]) == 3


def test_params_live_edit(view):
    """Parameter edits write back through the executor with dirty tracking
    (ui.c:5272-5326)."""
    base = view.url.rstrip("/")
    before = json.loads(urllib.request.urlopen(base + "/params").read())
    assert before["f_number"] == pytest.approx(0.8)

    req = urllib.request.Request(
        base + "/params", method="POST",
        data=json.dumps({"f_number": 1.25}).encode())
    after = json.loads(urllib.request.urlopen(req).read())
    assert after["f_number"] == pytest.approx(1.25)
    b = view.beamformer._block(0)
    assert b.parameters.f_number == pytest.approx(1.25)
    assert b.dirty                # re-plans on next frame


def test_panels_page(view):
    """Dockable split/tab panel tree (the reference UI's panel system,
    ui.c Split/TabGroup, beamformer_core.c:1880-2056)."""
    base = view.url.rstrip("/")
    page = urllib.request.urlopen(base + "/panels").read().decode()
    for marker in ("splitLeaf", "closeTab", "tabbar", "divider",
                   "Compute Stats", "X-Plane", "Parameters"):
        assert marker in page


def test_bad_request_returns_400(view):
    # malformed query values must produce a 4xx, not a dropped connection
    # (size=0 once divided by zero server-side)
    import urllib.error
    for path in ("frame.png?db=nan-garbage", "mip.png?size=abc",
                 "oblique.png?nx=zz"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(view.url + path)
        assert ei.value.code == 400


def test_size_clamped(view):
    # size clamps to the 16..512 range instead of dividing by zero
    # (or hogging the single-core VM with a huge render)
    status, ctype, body = _get(view.url + "mip.png?size=0")
    assert status == 200 and body.startswith(b"\x89PNG")
    status, ctype, body = _get(view.url + "oblique.png?size=99999")
    assert status == 200 and body.startswith(b"\x89PNG")


def test_frame_zoom_region(view):
    # zoomed region renders and differs from the full view at equal size
    s0, _, full = _get(view.url + "frame.png?out=128")
    s1, _, zoom = _get(view.url +
                       "frame.png?x0=0.25&y0=0.25&x1=0.75&y1=0.75&out=128")
    assert s0 == 200 and s1 == 200
    assert full.startswith(b"\x89PNG") and zoom.startswith(b"\x89PNG")
    assert full != zoom


def test_frame_meta_rulers(view):
    # world extents for rulers match the fixture's das_voxel_transform
    status, _, body = _get(view.url + "frame_meta.json")
    meta = json.loads(body)
    assert status == 200
    np.testing.assert_allclose(meta["lat_mm"], [0.0, 7 * 0.3], atol=1e-6)
    np.testing.assert_allclose(meta["ax_mm"], [1.0, 8.0], atol=1e-6)
    assert meta["shape"] == [16, 12]


def test_ascan_endpoint_matches_viewer(view):
    # the served A-scan equals viewer.a_scan on the same frame
    from ogl_beamforming_tpu.viewer import a_scan
    status, _, body = _get(view.url + "ascan.json?frac=0.5")
    a = json.loads(body)
    assert status == 200
    frame = view.beamformer.get_last_frames(1)[-1]
    expect = a_scan(frame, a["lateral_index"])
    got = np.asarray(a["values"]) * a["peak"]
    np.testing.assert_allclose(got, expect, rtol=1e-5)
    assert a["ax_mm"][0] == pytest.approx(1.0)
    assert a["ax_mm"][-1] == pytest.approx(8.0)
