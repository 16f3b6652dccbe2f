"""The path tracer's looped K6: every bounce of a path in one launch.

The oracle is the fused body as it was before the looped K6: one K6 a
bounce (its plain version on CPU tensors, one single-bounce launch on the
card) in ``pt_tile_rays`` tiles, a generator's uniforms drawn bounce by
bounce (:func:`per_bounce_ray_color`).  On the CPU: the uniforms drawn up
front (``pathtracer.draw_bounces``), the route decision
(``pathtracer.trace_tiles``), the wrapper's checks, and the looped K6's
plain version against the oracle.  On the card (marker ``cuda``): the
looped route against the oracle, bit for bit, on injected and on generated
uniforms, with its launches and counters.

Needs no JAX, so the card's tests run where the card is:

    python -m pytest --noconftest -q tests/test_torch_pt_loop.py
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator import pathtracer as PT
from distributionraytracer_tpu_torch.ops import cuda_pt as CP
from distributionraytracer_tpu_torch.scene import SCENE_BUILDERS
from distributionraytracer_tpu_torch.utils import spans

from torch_scenes import PT_VIEWS, pt_rays, synthetic_faces

torch.set_num_threads(1)

CPU = torch.device("cpu")
CUDA = torch.device("cuda")


def _scene(si, device=CPU):
    args = () if si == 0 else synthetic_faces(si)
    return SCENE_BUILDERS[si](*args).to(device)


_RAY_COLOR = PT.ray_color
_TRACE_TILES = PT.trace_tiles


def per_bounce_ray_color(scene, cfg, o, d, time, generator=None,
                         uniforms=None, queries=None, tables=None):
    """``pathtracer.ray_color`` with the fused body as one K6 a bounce
    (``cuda_pt.pt_bounce``) on one (S, R) state, a generator's uniforms
    drawn bounce by bounce, one ``pt.bounce`` span a bounce; the staged
    body as ``ray_color`` has it."""
    if queries is not None or cfg.kernels == "off":
        return _RAY_COLOR(scene, cfg, o, d, time, generator, uniforms,
                          queries, tables)
    R = o.shape[0]
    if generator is None and uniforms is None:
        generator = torch.Generator(device=o.device).manual_seed(0)
    tb = tables if tables is not None else CP.pt_tables(scene)
    n_ql = scene.qlight_pos.shape[0]
    state = CP.bounce_state(o, d, time)
    for b in range(cfg.max_bounces):
        with spans.span("pt.bounce"):
            spans.count("pt.paths", R)
            if spans.enabled():
                spans.count_device("pt.paths_live",
                                   torch.count_nonzero(state[CP.ST_ALIVE]))
            u = (uniforms.bounce(b) if uniforms is not None
                 else PT.draw_uniforms(scene, R, generator, o.device))
            CP.pt_bounce(scene, state,
                         CP.bounce_streams(u.uch, u.u3a, u.u3b, u.urr, u.uq,
                                           n_ql),
                         cfg.russian_roulette, tables=tb)
    return PT._sky_gather(scene, state[CP.ST_COL].T, state[CP.ST_MW].T,
                          state[CP.ST_MD].T)


@contextlib.contextmanager
def _per_bounce():
    """The path tracer's route before the looped K6: ``pt_tile_rays``
    tiles whatever the uniforms, one K6 a bounce in each."""
    tiled = lambda R, cfg, device, injected, queries=None: _TRACE_TILES(
        R, cfg, device, False, queries)
    with mock.patch.object(PT, "ray_color", per_bounce_ray_color), \
            mock.patch.object(PT, "trace_tiles", tiled):
        yield


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("si", [0, 3])
def test_draw_bounces_are_the_per_bounce_draws(si):
    """B bounces drawn up front are, in order, the numbers of B
    ``draw_uniforms`` calls one a bounce (scene 3 has a quad light, so its
    ``uq`` has two columns a light)."""
    scene = _scene(si)
    R, B = 301, 4
    g_up = torch.Generator().manual_seed(9)
    up = PT.draw_bounces(scene, R, B, g_up, CPU)
    g = torch.Generator().manual_seed(9)
    each = [PT.draw_uniforms(scene, R, g, CPU) for _ in range(B)]
    for name, x in zip(PT.BounceUniforms._fields, up):
        assert x.shape[:2] == (B, R) and x.dtype == torch.float32
        assert x.is_contiguous()
        assert torch.equal(x, torch.stack([getattr(u, name) for u in each]))
    # both leave the generator where the next tile's draws start
    assert torch.equal(torch.rand(5, generator=g_up),
                       torch.rand(5, generator=g))


def test_draw_bounces_of_no_bounce_are_empty():
    up = PT.draw_bounces(_scene(0), 7, 0, torch.Generator().manual_seed(1),
                         CPU)
    assert [tuple(x.shape) for x in up] == [(0, 7, 2), (0, 7), (0, 7, 3),
                                            (0, 7, 3), (0, 7)]


TILE = 1000
# (device, injected, staged or off, pt_tile_rays, R) -> tile starts
ROUTES = {
    "card_injected": (CUDA, True, None, TILE, 3500, [0]),
    "card_generated": (CUDA, False, None, TILE, 3500, [0, 1000, 2000, 3000]),
    "cpu_injected": (CPU, True, None, TILE, 3500, [0, 1000, 2000, 3000]),
    "cpu_generated": (CPU, False, None, TILE, 3500, [0, 1000, 2000, 3000]),
    "card_injected_staged": (CUDA, True, "staged", TILE, 3500,
                             [0, 1000, 2000, 3000]),
    "card_injected_kernels_off": (CUDA, True, "off", TILE, 3500,
                                  [0, 1000, 2000, 3000]),
    "card_generated_untiled": (CUDA, False, None, 0, 3500, [0]),
    "card_injected_short": (CUDA, True, None, TILE, 300, [0]),
    "card_injected_empty": (CUDA, True, None, TILE, 0, []),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_trace_tiles_decides_from_the_input(case):
    """One call over all R where the looped K6 (the fused body on CUDA
    tensors) takes injected uniforms; ``pt_tile_rays`` tiles, the last
    shorter, where a generator draws them, on CPU tensors, and on the
    staged body."""
    device, injected, body, tile, R, starts = ROUTES[case]
    cfg = RenderConfig(pt_tile_rays=tile,
                       kernels="off" if body == "off" else "auto")
    queries = PT.plain_queries(_scene(0)) if body == "staged" else None
    ranges = PT.trace_tiles(R, cfg, device, injected, queries)
    assert [a for a, _ in ranges] == starts
    assert [b for _, b in ranges] == starts[1:] + ([R] if R else [])


def test_pt_trace_kernel_refuses_cpu_tensors():
    scene = _scene(0)
    o, d, tm = (torch.from_numpy(a) for a in pt_rays(8, 0, PT_VIEWS[0][0]))
    u = PT.draw_bounces(scene, 8, 2, torch.Generator().manual_seed(0), CPU)
    with pytest.raises(ValueError, match="CUDA tensors"):
        CP.pt_trace_kernel(scene, o, d, tm, u, True)


def _cpu_inputs(si, R, B, seed):
    o, d, tm = (torch.from_numpy(np.ascontiguousarray(a))
                for a in pt_rays(R, seed, *PT_VIEWS[si]))
    u = PT.draw_bounces(_scene(si), R, B, torch.Generator().manual_seed(seed),
                        CPU)
    return o, d, tm, u


@pytest.mark.parametrize("rr", [True, False], ids=["roulette", "no_roulette"])
@pytest.mark.parametrize("si", [0, 3])
def test_pt_trace_on_cpu_is_b_plain_bounces(si, rr):
    """On CPU tensors ``pt_trace`` is the looped K6's plain version: B
    bounces of ``pt_bounce_plain`` on one state, launching nothing; the
    cubemap scene's latched miss rows come out, the gradient sky's do
    not."""
    scene = _scene(si)
    R, B = 300, 5
    o, d, tm, u = _cpu_inputs(si, R, B, 30 + si)
    CP.reset_launches()
    got = CP.pt_trace(scene, o, d, tm, u, rr)
    assert _launches() == {}
    state = CP.bounce_state(o, d, tm)
    for b in range(B):
        x = u.bounce(b)
        CP.pt_bounce_plain(scene, state, CP.bounce_streams(
            x.uch, x.u3a, x.u3b, x.urr, x.uq, scene.qlight_pos.shape[0]), rr)
    assert float(got.col.std()) > 0.01
    assert torch.equal(got.col, state[CP.ST_COL].T)
    if si == 0:
        assert got.mw is None and got.md is None
    else:
        assert torch.equal(got.mw, state[CP.ST_MW].T)
        assert torch.equal(got.md, state[CP.ST_MD].T)


@pytest.mark.parametrize("injected", [True, False],
                         ids=["injected", "generated"])
def test_cpu_fused_body_is_one_pt_trace_a_tile(injected):
    """``render_pt`` on CPU tensors: the fused body makes one ``pt_trace``
    call (one ``pt.bounce`` span) a ``pt_tile_rays`` tile, on injected
    uniforms too, and gives the per-bounce loop's image and path counts,
    bit for bit, with a generator's uniforms drawn bounce by bounce."""
    cfg = RenderConfig(max_bounces=4, pt_tile_rays=100)
    frame = _frame(CPU, 3, injected, cfg, W=16, H=12, S=2)
    tiles = -(-16 * 12 * 2 // cfg.pt_tile_rays)
    recs, imgs = [], []
    for route in (contextlib.nullcontext(), _per_bounce()):
        spans.collect()
        spans.enable()
        try:
            with route:
                imgs.append(frame())
            recs.append(spans.collect())
        finally:
            spans.disable()
            spans.collect()
    assert float(imgs[1].std()) > 0.02 and torch.equal(imgs[0], imgs[1])
    n_spans = lambda r, n: sum(s["name"] == n for s in r["spans"])
    assert [n_spans(r, "pt.tile") for r in recs] == [tiles, tiles]
    assert [n_spans(r, "pt.bounce") for r in recs] == [tiles, 4 * tiles]
    counts = [{c["name"]: c["n"] for c in r["counts"]} for r in recs]
    for name in ("pt.paths", "pt.paths_live"):
        assert counts[0][name] == counts[1][name]
    assert 0 < counts[0]["pt.paths_live"] < counts[0]["pt.paths"]


def test_trace_uniforms_are_read_in_place_and_checked():
    """The looped K6 reads a tile's lanes of the frame's stacked uniforms
    through their strides (no copy); a vector whose components are not
    adjacent is copied; a shape that is not (B, R, ...) is refused."""
    scene = _scene(3)
    u = PT.draw_bounces(scene, 50, 3, torch.Generator().manual_seed(4), CPU)
    tile = u.lanes(10, 30)
    got = CP._trace_uniforms(tile, 20, scene.qlight_pos.shape[0])
    for x, y in zip(got, tile):
        assert x.data_ptr() == y.data_ptr() and x.stride() == y.stride()
    apart = u._replace(u3a=u.u3a.transpose(1, 2).contiguous().transpose(1, 2))
    got = CP._trace_uniforms(apart, 50, 1)
    assert got.u3a.stride(2) == 1 and torch.equal(got.u3a, u.u3a)
    with pytest.raises(ValueError, match="u3b"):
        CP._trace_uniforms(u._replace(u3b=u.u3b[:, :, :2]), 50, 1)
    with pytest.raises(ValueError, match="uq"):
        CP._trace_uniforms(u, 50, 2)  # two quad lights need four columns


# ----------------------------------------------------------------- card
@pytest.fixture
def dev():
    """A CUDA device, or a skip where the machine has no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _inputs(dev, si, R, B, seed):
    o, d, tm = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in pt_rays(R, seed, *PT_VIEWS[si]))
    u = PT.draw_bounces(_scene(si), R, B,
                        torch.Generator(device=dev).manual_seed(seed), dev)
    return o, d, tm, u


def _launches():
    return {k: v for k, v in CP.LAUNCHES.items() if v}


@pytest.mark.cuda
@pytest.mark.parametrize("rr", [True, False], ids=["roulette", "no_roulette"])
@pytest.mark.parametrize("si", [0, 1, 3])
def test_looped_k6_equals_a_launch_a_bounce(dev, si, rr):
    """``ray_color`` on the looped K6 against one single-bounce K6 launch a
    bounce, on the same injected uniforms, bit for bit: scene 0 (gradient
    sky, moving spheres, point lights), scene 1 (cubemap, quad light) and
    scene 3 (cubemap, quad light, the Cornell box), roulette on and off,
    R not a multiple of the block's 256 lanes."""
    scene = _scene(si, dev)
    R, B = 40_000 + 37, 10
    o, d, tm, u = _inputs(dev, si, R, B, 70 + si)
    cfg = RenderConfig(max_bounces=B, russian_roulette=rr)
    CP.reset_launches()
    got = PT.ray_color(scene, cfg, o, d, tm, uniforms=u)
    torch.cuda.synchronize()
    assert _launches() == {"pt_trace": 1}
    CP.reset_launches()
    want = per_bounce_ray_color(scene, cfg, o, d, tm, uniforms=u)
    torch.cuda.synchronize()
    assert _launches() == {"pt_bounce": B}
    assert float(want.std()) > 0.02
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_looped_k6_reads_a_tiles_lanes_in_place(dev):
    """A tile of the frame's uniforms (a strided view, offset by its first
    lane) gives what the per-bounce route gives on the same lanes, and what
    the whole frame's call gives there."""
    scene = _scene(3, dev)
    R, B, a, b = 5_000, 6, 1_234, 4_321
    o, d, tm, u = _inputs(dev, 3, R, B, 81)
    cfg = RenderConfig(max_bounces=B)
    whole = PT.ray_color(scene, cfg, o, d, tm, uniforms=u)
    got = PT.ray_color(scene, cfg, o[a:b], d[a:b], tm[a:b],
                       uniforms=u.lanes(a, b))
    want = per_bounce_ray_color(scene, cfg, o[a:b], d[a:b], tm[a:b],
                                uniforms=u.lanes(a, b))
    assert torch.equal(got, want) and torch.equal(got, whole[a:b])


def _frame(dev, si, injected, cfg, W=48, H=32, S=4):
    scene = _scene(si, dev)
    eye, at = ([6, 1.6, -6], [0, 0.5, 0]) if si == 0 else (
        [0, -3, -6], [0, -3, 10])
    if not injected:
        return lambda: PT.render_pt(
            scene, cfg, W, H, torch.Generator(device=dev).manual_seed(3),
            eye=eye, at=at, spp=S)
    g = torch.Generator(device=dev).manual_seed(5)
    samples = PT.PTSamples(
        torch.rand((H, W, S, 2), generator=g, device=dev),
        torch.rand((H, W, S), generator=g, device=dev),
        PT.draw_bounces(scene, H * W * S, cfg.max_bounces, g, dev))
    return lambda: PT.render_pt(scene, cfg, W, H, eye=eye, at=at, spp=S,
                                samples=samples)


@pytest.mark.cuda
@pytest.mark.parametrize("si", [0, 3])
def test_generated_uniforms_keep_their_tiles_and_image(dev, si):
    """``render_pt`` from a generator: one looped launch a tile, each tile's
    bounces drawn up front, against the per-bounce route drawing bounce by
    bounce: the same image, bit for bit, over several tiles."""
    cfg = RenderConfig(max_bounces=8, pt_tile_rays=1_000)
    frame = _frame(dev, si, False, cfg)
    tiles = -(-48 * 32 * 4 // cfg.pt_tile_rays)
    CP.reset_launches()
    got = frame()
    torch.cuda.synchronize()
    assert _launches() == {"pt_trace": tiles}
    CP.reset_launches()
    with _per_bounce():
        want = frame()
    torch.cuda.synchronize()
    assert _launches() == {"pt_bounce": tiles * cfg.max_bounces}
    assert float(want.std()) > 0.02 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("si", [0, 3])
def test_injected_frame_is_one_launch_and_the_tiled_routes_image(dev, si):
    """``render_pt`` on injected uniforms: one looped launch for the whole
    frame, whatever ``pt_tile_rays``, and the per-bounce route's tiled
    image, bit for bit."""
    cfg = RenderConfig(max_bounces=10, pt_tile_rays=1_000)
    frame = _frame(dev, si, True, cfg)
    CP.reset_launches()
    got = frame()
    torch.cuda.synchronize()
    assert _launches() == {"pt_trace": 1}
    with _per_bounce():
        want = frame()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("injected", [True, False],
                         ids=["injected", "generated"])
def test_looped_route_counts_the_per_bounce_routes_paths(dev, injected):
    """With the recorder on, ``pt.paths`` and ``pt.paths_live`` of the
    looped route equal the per-bounce route's; one ``pt.bounce`` span a
    ``pt_trace`` call; the image is the recorder-off image."""
    cfg = RenderConfig(max_bounces=10, pt_tile_rays=2_000)
    frame = _frame(dev, 0, injected, cfg)
    off = frame()
    recs = []
    for route in (None, _per_bounce()):
        spans.collect()
        spans.enable()
        try:
            if route is None:
                on = frame()
            else:
                with route:
                    frame()
            recs.append(spans.collect())
        finally:
            spans.disable()
            spans.collect()
    assert torch.equal(off, on)
    counts = [{c["name"]: c["n"] for c in r["counts"]} for r in recs]
    for name in ("pt.paths", "pt.paths_live"):
        assert counts[0][name] == counts[1][name]
    assert 0 < counts[0]["pt.paths_live"] < counts[0]["pt.paths"]
    n_spans = lambda r, n: sum(s["name"] == n for s in r["spans"])
    assert n_spans(recs[0], "pt.bounce") == n_spans(recs[0], "pt.tile")
    assert n_spans(recs[1], "pt.bounce") == 10 * n_spans(recs[1], "pt.tile")
