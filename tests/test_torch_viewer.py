"""The port's browser viewer and ``view`` CLI vs the JAX package's: the
page, the orbit camera, the progressive glue (on stand-in frames), the
HTTP routes, a replay of real frames, the PNG bytes and the CLI."""

import contextlib
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from distributionraytracer_tpu import viewer as JV
from distributionraytracer_tpu.config import RenderConfig as JaxConfig
from distributionraytracer_tpu.integrator import pathtracer as JPT
from distributionraytracer_tpu_torch import cli
from distributionraytracer_tpu_torch import viewer as V
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator import pathtracer as PT
from distributionraytracer_tpu_torch.renderer import Renderer
from distributionraytracer_tpu_torch.scene import SceneBuilder
from distributionraytracer_tpu_torch.utils.image import png_bytes, read_png

from torch_port_util import prim_scene, to_port
from torch_scenes import mesh_scene

torch.set_num_threads(1)

RES = 24
TITLE = "<title>distributionraytracer_tpu{}</title>"


def jax_scene(eye=None):
    """``prim_scene`` at RES x RES, built by the JAX package."""
    s = prim_scene()
    s = dataclasses.replace(s, static=dataclasses.replace(
        s.static, res_x=RES, res_y=RES))
    if eye is not None:
        s = dataclasses.replace(s, cam_eye=np.array(eye, np.float32))
    return s


@contextlib.contextmanager
def serving(httpd):
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
        assert not t.is_alive()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=300) as r:
        return r.read(), dict(r.headers)


def _status(port, path):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, path)
    return e.value.code


# ----------------------------------------------------------------- the page
def test_page_equals_jax_page_but_its_title():
    assert TITLE.format("_torch") in V._PAGE
    assert (V._PAGE.replace(TITLE.format("_torch"), "")
            == JV._PAGE.replace(TITLE.format(""), ""))


def test_page_has_capture_and_pause_ui():
    """Mirror of ``test_viewer.py::test_page_has_capture_and_pause_ui``:
    webm recording (MediaRecorder over a canvas fed from each frame) and a
    pause/restart control (P3D_RT.html:2301-2342)."""
    assert "MediaRecorder" in V._PAGE
    assert "capture.webm" in V._PAGE
    assert "paused" in V._PAGE and "toggleRecord" in V._PAGE
    assert "/reset" in V._PAGE


# --------------------------------------------------------------- the camera
ORBITS = [(a, b, r) for a in (-170.0, -30.5, 0.0, 45.0, 181.25)
          for b in (-85.0, -10.0, 0.0, 37.5, 85.0) for r in (0.1, 3.0, 17.1)]


@pytest.mark.parametrize("eye", [[0, 1, 6], [2.5, -1, -4], [3, 2, 0]],
                         ids=["front", "behind", "z0"])
def test_whitted_camera_matches_jax(eye):
    """Initial spherical coordinates (``atan``, not ``atan2``; 90 degrees
    where eye.z is 0) and ``_eye`` over a grid of orbits."""
    js = jax_scene(eye)
    ref = JV.ViewerState(js, JaxConfig(spp=1))
    got = V.ViewerState(to_port(js), RenderConfig(spp=1), device="cpu")
    np.testing.assert_allclose(
        [got.alpha0, got.beta0, got.r0], [ref.alpha0, ref.beta0, ref.r0],
        rtol=1e-6)
    assert json.loads(got.as_json()) == json.loads(ref.as_json())
    for st in (ref, got):
        st._eyes = []
        for a, b, r in ORBITS:
            st.alpha, st.beta, st.r = a, b, r
            st._eyes.append(st._eye())
    np.testing.assert_allclose(got._eyes, ref._eyes, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scene_id", range(5))
def test_pt_camera_matches_jax(scene_id):
    ref = JV.PTViewerState(scene_id, JaxConfig(max_bounces=2), res=(8, 6))
    got = V.PTViewerState(scene_id, RenderConfig(max_bounces=2), res=(8, 6),
                          device="cpu")
    assert got.SCENE_CAM == ref.SCENE_CAM
    np.testing.assert_array_equal(got.at, ref.at)
    assert (got.alpha0, got.beta0, got.r0) == (ref.alpha0, ref.beta0, ref.r0)
    for a, b, r in ORBITS:
        for st in (ref, got):
            st.alpha, st.beta, st.r = a, b, r
        np.testing.assert_allclose(got._eye(), ref._eye(), rtol=1e-6,
                                   atol=1e-6)


# ----------------------------------------------------------------- the glue
# (alpha, beta, r, progressive) of each request, then a reset ("reset")
REQUESTS = [(10.0, 20.0, 3.0, True), (10.0, 20.0, 3.0, True),
            (10.00001, 20.0, 3.0, True),  # rounds to the same camera
            (55.0, 20.0, 3.0, True), (55.0, 20.0, 3.0, True),
            (55.0, 20.0, 3.0, False),  # a batch frame
            (55.0, 20.0, 3.0, True), "reset", (0.0, 9.5, 6.1, True),
            (0.0, 9.5, 6.1, True)]


def stand_in_frames(shape, n=32, seed=3):
    """The frames the stand-in renderers return, one a call, in order:
    numpy-seeded, some channels above 1 (the u8 saturation)."""
    rng = np.random.default_rng(seed)
    return [(rng.random(shape) * 1.2).astype(np.float32) for _ in range(n)]


def assert_u8_close(a, b):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4


def drive(state, requests):
    """(X-Samples, u8 frame) of each request, as the handler makes them."""
    out = []
    for q in requests:
        if q == "reset":
            state.reset()
            continue
        rgb, n = state.frame(*q)
        out.append((str(n), rgb))
    return out


def test_whitted_glue_matches_jax():
    """Both ViewerStates through one request sequence, each renderer's
    ``render_with_samples`` (what ``progressive_step`` and ``render``
    call) standing in with the same frames: counts, eyes, u8 frames."""
    js = jax_scene()
    cfg = dict(spp=4)
    ref = JV.ViewerState(js, JaxConfig(**cfg))
    got = V.ViewerState(to_port(js), RenderConfig(**cfg), device="cpu")
    frames = stand_in_frames((RES, RES, 3))
    eyes = {"jax": [], "port": []}

    def jax_render(samples, return_rays=False):
        eyes["jax"].append(np.asarray(ref.renderer.scene.cam_eye))
        return jnp.asarray(frames[len(eyes["jax"]) - 1])

    def port_render(samples, return_rays=False):
        eyes["port"].append(got.renderer.scene.cam_eye.numpy())
        assert samples.time.shape[-1] == (4 if len(eyes["port"]) == 6
                                          else 1)
        return torch.from_numpy(frames[len(eyes["port"]) - 1])

    ref.renderer.render_with_samples = jax_render
    got.renderer.render_with_samples = port_render
    a, b = drive(ref, REQUESTS), drive(got, REQUESTS)
    assert [n for n, _ in b] == [n for n, _ in a] == [
        "1.0", "2.0", "3.0", "1.0", "2.0", "4", "3.0", "1.0", "2.0"]
    for (_, ra), (_, rb) in zip(a, b):
        assert_u8_close(rb, ra)
    np.testing.assert_allclose(eyes["port"], eyes["jax"], rtol=1e-6,
                               atol=1e-6)
    assert got.renderer.scene.cam_eye.dtype == torch.float32
    np.testing.assert_allclose(float(got.prog_state[1]),
                               float(ref.prog_state[1]))
    np.testing.assert_allclose(got.prog_state[0].numpy(),
                               np.asarray(ref.prog_state[0]), rtol=1e-6)


def test_pt_glue_matches_jax(monkeypatch):
    """Both PTViewerStates through one request sequence, each package's
    ``render_pt`` standing in with the same frames: counts, eyes, the
    linear mean, the u8 frames (gamma on the host)."""
    res, chunk = (16, 12), 2
    ref = JV.PTViewerState(0, JaxConfig(max_bounces=2), res=res,
                           chunk_spp=chunk)
    got = V.PTViewerState(0, RenderConfig(max_bounces=2), res=res,
                          chunk_spp=chunk, device="cpu")
    frames = stand_in_frames((res[1], res[0], 3), seed=4)
    calls = {"jax": [], "port": []}

    def stand_in(name, wrap):
        def render_pt(scene, cfg, res_x, res_y, *a, eye=None, at=None,
                      spp=1, **kw):
            assert (res_x, res_y, spp) == (*res, chunk)
            calls[name].append((np.asarray(eye), np.asarray(at)))
            return wrap(frames[len(calls[name]) - 1])
        return render_pt

    monkeypatch.setattr(JPT, "render_pt", stand_in("jax", jnp.asarray))
    monkeypatch.setattr(PT, "render_pt", stand_in("port", torch.from_numpy))
    a, b = drive(ref, REQUESTS), drive(got, REQUESTS)
    assert [n for n, _ in b] == [n for n, _ in a]
    assert [float(n) for n, _ in b] == [2, 4, 6, 2, 4, 6, 8, 2, 4]
    for (_, ra), (_, rb) in zip(a, b):
        assert_u8_close(rb, ra)
    for (eye_j, at_j), (eye_p, at_p) in zip(calls["jax"], calls["port"]):
        np.testing.assert_allclose(eye_p, eye_j, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(at_p, at_j)
    assert len(calls["port"]) == len(calls["jax"]) == 9
    assert got.mean.dtype == np.float32
    np.testing.assert_allclose(got.mean, ref.mean, rtol=1e-6)
    assert got.count == ref.count


# ------------------------------------------------------------- HTTP routes
@pytest.fixture(scope="module")
def server():
    """Mirror of ``test_viewer.py``'s ``server`` fixture on an in-repo
    scene: the port's Whitted viewer at 24x24, spp 1, on a free port."""
    httpd = V.make_server(to_port(jax_scene()), RenderConfig(spp=1), 0,
                          device="cpu")
    with serving(httpd) as port:
        yield port


def test_viewer_page_and_state(server):
    body, _ = _get(server, "/")
    assert b"distributionraytracer_tpu" in body
    assert b'width="24" height="24"' in body
    body, _ = _get(server, "/state")
    st = json.loads(body)
    assert {"alpha", "beta", "r", "progressive"} <= set(st)


def test_viewer_progressive_frames_and_reset(server):
    b1, h1 = _get(server, "/frame?alpha=10&beta=20&r=3&progressive=1")
    assert b1[:4] == b"\x89PNG"
    assert float(h1["X-Samples"]) == 1.0
    assert h1["Cache-Control"] == "no-store"
    _, h2 = _get(server, "/frame?alpha=10&beta=20&r=3&progressive=1")
    assert float(h2["X-Samples"]) == 2.0  # accumulating
    # camera motion resets the accumulator (FrameCount = 1)
    _, h3 = _get(server, "/frame?alpha=55&beta=20&r=3&progressive=1")
    assert float(h3["X-Samples"]) == 1.0
    # batch (non-progressive) frame works too
    b4, h4 = _get(server, "/frame?alpha=55&beta=20&r=3&progressive=0")
    assert b4[:4] == b"\x89PNG" and h4["X-Samples"] == "1"
    body, _ = _get(server, "/reset")
    assert json.loads(body)["progressive"] is True


def test_viewer_screenshot(server, tmp_path):
    _get(server, "/frame?alpha=10&beta=20&r=3&progressive=1")
    out = tmp_path / "shot.png"
    body, _ = _get(server, f"/screenshot?path={out}")
    meta = json.loads(body)
    assert meta["path"] == str(out) and meta["samples"] == 1.0
    with open(out, "rb") as f:
        assert f.read(4) == b"\x89PNG"
    img = read_png(str(out))
    assert img.shape == (24, 24, 3)


def test_viewer_errors_before_a_frame_and_unknown_route():
    httpd = V.make_server(to_port(jax_scene()), RenderConfig(spp=1), 0,
                          device="cpu")
    with serving(httpd) as port:
        assert _status(port, "/screenshot") == 409
        assert _status(port, "/nothing") == 404
        _get(port, "/frame")  # the state's own camera
        assert _status(port, "/nothing") == 404


@pytest.fixture(scope="module")
def pt_server():
    state = V.PTViewerState(0, RenderConfig(max_bounces=3), res=(32, 24),
                            chunk_spp=1, device="cpu")
    with serving(V.make_server(None, None, 0, state=state)) as port:
        yield port, state


def test_pt_viewer_progressive_refinement(pt_server):
    port, state = pt_server
    body, hdrs = _get(port, "/frame?alpha=45&beta=10&r=8.86&progressive=1")
    assert body[:4] == b"\x89PNG"
    assert float(hdrs["X-Samples"]) == 1.0
    _, hdrs = _get(port, "/frame?alpha=45&beta=10&r=8.86&progressive=1")
    assert float(hdrs["X-Samples"]) == 2.0
    # orbit move -> accumulator reset (w reset, P3D_RT.glsl:779-783)
    _, hdrs = _get(port, "/frame?alpha=60&beta=10&r=8.86&progressive=1")
    assert float(hdrs["X-Samples"]) == 1.0
    assert np.isfinite(state.mean).all() and state.mean.std() > 0.01


def test_pt_viewer_screenshot(pt_server, tmp_path):
    port, state = pt_server
    _get(port, "/frame?alpha=45&beta=10&r=8.86&progressive=1")
    p = tmp_path / "shot.png"
    body, _ = _get(port, f"/screenshot?path={p}")
    out = json.loads(body)
    assert out["path"] == str(p) and out["samples"] == state.count
    assert p.exists() and p.stat().st_size > 100
    np.testing.assert_array_equal(
        np.round(read_png(str(p)) * 255.99).astype(np.uint8), state.last_rgb)


# ------------------------------------------------------------------ replay
def replay(scene, cfg, eye, seeds, state=None):
    """``Renderer.progressive_step`` at ``eye`` on the viewer's generators
    of frames ``seeds``."""
    r = Renderer(scene, cfg, device="cpu")
    r.scene = dataclasses.replace(r.scene, cam_eye=torch.as_tensor(eye))
    state = r.progressive_init() if state is None else state
    for i in seeds:
        state = r.progressive_step(state, V._frame_generator(r.device, 0, i))
    return state


def test_whitted_viewer_equals_progressive_step_replay():
    scene, cfg = to_port(jax_scene()), RenderConfig(spp=1)
    st = V.ViewerState(scene, cfg, device="cpu")
    for _ in range(3):
        st.frame(10.0, 20.0, 3.0, True)
    mean, count = replay(scene, cfg, st._eye(), (1, 2, 3))
    assert float(st.prog_state[1]) == float(count) == 3.0
    assert torch.equal(st.prog_state[0], mean)
    assert mean.std() > 0.01


def test_bvh_viewer_rebuilds_primary_bins_on_a_move():
    """A BVH scene on the binned route: after a camera move the frame is
    the one a renderer made at the new camera gives (no stale bins)."""
    scene = mesh_scene(SceneBuilder, n_tri=2000, accel=2, res=(16, 16))
    cfg = RenderConfig(spp=0)
    st = V.ViewerState(scene, cfg, device="cpu")
    assert st.renderer.executed_backend() == "binned-primary+grouped-packet"
    st.frame(st.alpha0, st.beta0, st.r0, True)
    st.frame(st.alpha0 + 20.0, st.beta0, st.r0, True)
    mean, count = replay(scene, cfg, st._eye(), (2,))
    assert float(st.prog_state[1]) == float(count) == 1.0
    assert torch.equal(st.prog_state[0], mean)


# --------------------------------------------------------------------- PNG
@pytest.mark.parametrize("shape", [(24, 24, 3), (7, 13, 3)])
def test_png_bytes_match_jax(shape, tmp_path):
    rgb = np.random.default_rng(shape[1]).integers(0, 256, shape, np.uint8)
    ours, theirs = png_bytes(rgb), JV._png_bytes(rgb)
    a = np.asarray(Image.open(io.BytesIO(ours)).convert("RGB"))
    b = np.asarray(Image.open(io.BytesIO(theirs)).convert("RGB"))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, rgb[::-1])  # y-up buffer, flipped
    for name, data in (("ours", ours), ("theirs", theirs)):
        (tmp_path / name).write_bytes(data)
    np.testing.assert_array_equal(read_png(str(tmp_path / "ours")),
                                  read_png(str(tmp_path / "theirs")))


# --------------------------------------------------------------------- CLI
P3F = """accel none
spp 4
camera eye 0 1 6 at 0 0 0 up 0 1 0 angle 45 hither 0.01
  resolution 20 15 aperture 0 focal 1
bclr 0.1 0.2 0.4
light punctual 2 4 2 1 1 1
mat 0.6 0.6 0.2 0.8 0.2 0.2 0.2 0.0 10 0 1
s -0.8 0 0 0.8
"""


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    for name in ("serve", "serve_pt"):
        monkeypatch.setattr(V, name, lambda *a, _n=name, **kw: calls.append(
            (_n, a, kw)))
    return calls


def test_cli_view_parses_into_serve(recorded, tmp_path):
    path = tmp_path / "s.p3f"
    path.write_text(P3F)
    cli.main(["view", str(path), "--res", "24", "16", "--spp", "9",
              "--port", "0", "--device", "cpu"])
    ((name, (scene, cfg), kw),) = recorded
    assert name == "serve" and kw == dict(port=0, device="cpu")
    assert (scene.static.res_x, scene.static.res_y) == (24, 16)
    assert cfg.spp == 9 and scene.static.n_spheres == 1
    recorded.clear()
    cli.main(["view", str(path)])
    ((_, (scene, cfg), kw),) = recorded
    assert kw == dict(port=8765, device="cuda") and cfg.spp == 4


def test_cli_view_pt_parses_into_serve_pt(recorded):
    cli.main(["view", "--pt", "--pt-scene", "2", "--res", "40", "30",
              "--spp", "3", "--bounces", "5", "--cubemap", "sky",
              "--device", "cpu"])
    ((name, (scene_id, cfg), kw),) = recorded
    assert name == "serve_pt" and scene_id == 2
    assert cfg == RenderConfig(max_bounces=5)
    assert kw == dict(port=8765, res=(40, 30), cubemap="sky", chunk_spp=3,
                      device="cpu")
    recorded.clear()
    cli.main(["view", "--pt"])
    ((_, (scene_id, cfg), kw),) = recorded
    assert scene_id == 0 and cfg.max_bounces == 10
    assert kw == dict(port=8765, res=(400, 300), cubemap=None, chunk_spp=1,
                      device="cuda")


def test_cli_view_refuses_a_missing_scene(recorded):
    with pytest.raises(SystemExit, match="a scene path is required"):
        cli.main(["view", "--device", "cpu"])
    assert recorded == []


def test_viewer_states_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        V.ViewerState(to_port(jax_scene()), RenderConfig(spp=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        V.PTViewerState(0, RenderConfig(max_bounces=2), res=(8, 6))
