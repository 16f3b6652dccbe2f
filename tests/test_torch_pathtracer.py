"""The port's path tracer vs the JAX package: the scene queries (plain K4
and K5), one fused bounce (plain K6), ``ray_color``'s two bodies and
``render_pt`` on injected random numbers, the ``pathtrace`` CLI, and the
kernels' refusal of CPU tensors."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributionraytracer_tpu.config import RenderConfig as JaxConfig
from distributionraytracer_tpu.integrator import pathtracer as JPT
from distributionraytracer_tpu.ops import pallas_pt as PK
from distributionraytracer_tpu.scene import pt_scenes as JPS
from distributionraytracer_tpu_torch import cli
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator import pathtracer as PT
from distributionraytracer_tpu_torch.ops import cuda_pt as CP
from distributionraytracer_tpu_torch.scene import pt_scenes as PS
from distributionraytracer_tpu_torch.utils.image import read_png

from torch_scenes import (
    PT_PRIM_LEAVES, PT_VIEWS, pt_rays, pt_tie_leaves, synthetic_faces,
)

torch.set_num_threads(1)


def scenes(si, sky=True):
    """Scene ``si`` of both packages; cubemap scenes get synthetic faces."""
    args = () if si == 0 or not sky else synthetic_faces(si)
    js = JPS.SCENE_BUILDERS[si](*args)
    leaves = {n: np.asarray(getattr(js, n)) for n in PS.PTScene._LEAVES}
    return jax.device_put(js), PS.pt_scene_from_numpy(leaves, js.sky_mode)


def empty_scenes(si):
    """Scene ``si`` of both packages with every primitive table emptied:
    its materials, lights and sky stay."""
    js, ps = scenes(si)
    return (dataclasses.replace(js, **{n: getattr(js, n)[:0]
                                       for n in PT_PRIM_LEAVES}),
            dataclasses.replace(ps, **{n: getattr(ps, n)[:0]
                                       for n in PT_PRIM_LEAVES}))


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def jax_uniforms(key, R, n_ql, bounces) -> PT.BounceUniforms:
    """The uniforms of JAX ``ray_color``'s key schedule
    (pathtracer.py:529-534 under ``split(key, max_bounces)``), stacked
    over bounces."""
    per = []
    for k in jax.random.split(key, bounces):
        ks = jax.random.split(k, 4)
        per.append([jax.random.uniform(ks[0], (R, 2 * max(n_ql, 1))),
                    jax.random.uniform(ks[1], (R,)),
                    jax.random.uniform(ks[2], (R, 3)),
                    jax.random.uniform(ks[3], (R, 3)),
                    jax.random.uniform(jax.random.fold_in(k, 7), (R,))])
    return PT.BounceUniforms(*(t(np.stack([np.asarray(p[i]) for p in per]))
                               for i in range(5)))


def _query_rays(seed, R=3000):
    """The rays of ``test_pallas_pt._rays``."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 5, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0, 1, R).astype(np.float32)
    dist = rng.uniform(0.5, 20, R).astype(np.float32)
    return o, d, tm, dist


@pytest.mark.parametrize("si", [0, 3])
def test_scene_queries_match_jax(si):
    """hit_world / any_hit (the plain K4 / K5, and their CPU dispatch)
    against JAX's jnp queries and its Pallas kernels in interpret mode."""
    js, ps = scenes(si)
    o, d, tm, dist = _query_rays(si)
    jo, jd, jt, jdist = map(jnp.asarray, (o, d, tm, dist))
    refs = [jax.jit(JPT.hit_world)(js, jo, jd, jt),
            PK.pt_closest(js, jo, jd, jt, interpret=True)]
    for h in (PT.hit_world(ps, t(o), t(d), t(tm)),
              CP.pt_closest(ps, t(o), t(d), t(tm))):
        for ref in refs:
            hit = np.asarray(ref.hit)
            np.testing.assert_array_equal(h.hit.numpy(), hit)
            assert 0.05 < hit.mean() < 0.95
            np.testing.assert_allclose(h.t.numpy()[hit],
                                       np.asarray(ref.t)[hit], rtol=2e-4)
            np.testing.assert_array_equal(h.mat.numpy()[hit],
                                          np.asarray(ref.mat)[hit])
            dn = np.abs(h.normal.numpy()[hit] - np.asarray(ref.normal)[hit])
            assert (dn.max(-1) > 1e-3).mean() < 0.005
            # pos = o + d * t: t's rtol 2e-4 at t ~ 10
            np.testing.assert_allclose(h.pos.numpy(), np.asarray(ref.pos),
                                       rtol=2e-4, atol=2e-3)
    occ_refs = [np.asarray(jax.jit(JPT.any_hit)(js, jo, jd, jt, 1e-3,
                                                  jdist)),
                np.asarray(PK.pt_any_hit(js, jo, jd, jt, jdist,
                                         interpret=True))]
    for occ in (PT.any_hit(ps, t(o), t(d), t(tm), 1e-3, t(dist)),
                CP.pt_any_hit(ps, t(o), t(d), t(tm), t(dist))):
        for ref in occ_refs:
            np.testing.assert_array_equal(occ.numpy(), ref)
    assert occ_refs[0].any() and not occ_refs[0].all()


def _jax_bounce(js, state, u, b):
    o, d, col, thr, alive, time, mw, md = state
    return PK.pt_bounce(js, o, d, col, thr, alive, time, u.uch[b], u.u3a[b],
                        u.u3b[b], u.urr[b], uq=u.uq[b], miss_w=mw, miss_d=md,
                        rr=True, interpret=True)


def _jax_state(st):
    """The port's (20, R) state as JAX ``pt_bounce``'s arguments."""
    a = lambda rows: jnp.asarray(st[rows].numpy().T)
    return (a(CP.ST_O), a(CP.ST_D), a(CP.ST_COL), a(CP.ST_THR),
            jnp.asarray(st[CP.ST_ALIVE].numpy() > 0),
            jnp.asarray(st[CP.ST_TIME].numpy()), a(CP.ST_MW), a(CP.ST_MD))


@pytest.mark.parametrize("si", [0, 1])
def test_pt_bounce_plain_matches_jax_kernel(si):
    """One fused bounce (plain K6) against JAX ``pt_bounce`` in interpret
    mode, on a state whose first half is camera rays and whose second half
    is one bounce on (alive and dead paths, colour, throughput and latched
    misses).  Scene 1 has the quad light and the latched cubemap miss."""
    _bounce_vs_jax(*scenes(si), si)


def test_pt_bounce_plain_ties_match_jax():
    """As above on scene 0 with every triangle and sphere listed twice,
    the copies later and in the next material: the plain K6 agrees with
    JAX ``pt_bounce`` in interpret mode, and every tie in t goes to the
    lower index (the rule the kernel's group reduction reproduces): the
    closest hit's material and t equal those without the copies."""
    js0, ps0 = scenes(0)
    leaves = pt_tie_leaves({n: np.asarray(getattr(js0, n))
                            for n in PS.PTScene._LEAVES})
    js = jax.device_put(dataclasses.replace(
        js0, **{n: jnp.asarray(v) for n, v in leaves.items()}))
    ps = PS.pt_scene_from_numpy(leaves, js0.sky_mode)
    assert ps.sph_center.shape[0] == 2 * ps0.sph_center.shape[0]
    _bounce_vs_jax(js, ps, 0)
    o, d, tm = (t(a) for a in pt_rays(512, 5, *PT_VIEWS[0]))
    h, h0 = PT.hit_world(ps, o, d, tm), PT.hit_world(ps0, o, d, tm)
    assert torch.equal(h.hit, h0.hit) and torch.equal(h.t, h0.t)
    assert torch.equal(h.mat[h.hit], h0.mat[h0.hit])
    assert float(h.hit.float().mean()) > 0.3


def _bounce_vs_jax(js, ps, si):
    R, h = 96, 48
    o, d, tm = pt_rays(R, 3 + si, *PT_VIEWS[si])
    n_ql = ps.qlight_pos.shape[0]
    u = jax_uniforms(jax.random.PRNGKey(11 + si), R, n_ql, 2)
    uni = [CP.bounce_streams(u.uch[b], u.u3a[b], u.u3b[b], u.urr[b],
                             u.uq[b], n_ql) for b in range(2)]
    st = CP.bounce_state(t(o), t(d), t(tm))
    CP.pt_bounce_plain(ps, st, uni[0], True)
    st[:, :h] = CP.bounce_state(t(o[:h]), t(d[:h]), t(tm[:h]))
    assert 0 < int((st[CP.ST_ALIVE, h:] > 0).sum()) < R - h
    ju = PT.BounceUniforms(*(jnp.asarray(x.numpy()) for x in u))
    out = _jax_bounce(js, _jax_state(st), ju, 1)
    CP.pt_bounce_plain(ps, st, uni[1], True)
    ro, rd, rcol, rthr, ralive, rmw, rmd = (np.asarray(x) for x in out)
    alive = st[CP.ST_ALIVE].numpy() > 0
    np.testing.assert_array_equal(alive, ralive)
    assert 0 < alive[:h].sum() < h
    for rows, ref in ((CP.ST_O, ro), (CP.ST_D, rd), (CP.ST_COL, rcol),
                      (CP.ST_THR, rthr), (CP.ST_MW, rmw), (CP.ST_MD, rmd)):
        np.testing.assert_allclose(st[rows].numpy().T, ref,
                                   rtol=2e-3, atol=2e-3)
    assert (st[CP.ST_TIME] == 0).all()
    if si == 1:
        assert np.abs(rmw).sum() > 0  # some misses latched


@pytest.mark.parametrize("si", [0, 1, 3, 4])
def test_ray_color_bodies_match_jax(si):
    """Both bodies of ``ray_color`` (fused with the plain K6, staged with the
    plain queries and with the K4/K5 dispatchers) against JAX's jnp
    ``ray_color`` on its own key schedule, 4 bounces: all four materials
    (rough dielectrics in scene 1, plastics in scene 4) and all three
    skies."""
    js, ps = scenes(si)
    R = 384
    o, d, tm = pt_rays(R, 7 + si, *PT_VIEWS[si])
    key = jax.random.PRNGKey(11 + si)
    ref = np.asarray(JPT.ray_color(js, JaxConfig(max_bounces=4,
                                                 pallas="off"),
                                   jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tm), key))
    assert ref.std() > 0.01
    u = jax_uniforms(key, R, ps.qlight_pos.shape[0], 4)
    cfg = RenderConfig(max_bounces=4)
    for c, q in ((cfg, None), (cfg.replace(kernels="off"), None),
                 (cfg, PT.kernel_queries(ps))):
        got = PT.ray_color(ps, c, t(o), t(d), t(tm), uniforms=u, queries=q)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("si", [0, 3])
def test_ray_color_without_primitives_matches_jax(si):
    """A scene with no primitive takes the same bodies as any other (the
    fused one with K6 on the card): every path misses at once and sees the
    gradient sky (scene 0) or the cubemap (scene 3), as in JAX."""
    js, ps = empty_scenes(si)
    R = 64
    o, d, tm = pt_rays(R, 2, *PT_VIEWS[si])
    key = jax.random.PRNGKey(3)
    ref = np.asarray(JPT.ray_color(js, JaxConfig(max_bounces=2,
                                                 pallas="off"),
                                   jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tm), key))
    assert ref.min() > 0.0
    u = jax_uniforms(key, R, ps.qlight_pos.shape[0], 2)
    cfg = RenderConfig(max_bounces=2)
    for c in (cfg, cfg.replace(kernels="off")):
        got = PT.ray_color(ps, c, t(o), t(d), t(tm), uniforms=u)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-3)


def test_ray_color_tiles_take_their_lanes_uniforms():
    """Tiling with injected uniforms changes nothing: each tile takes its
    own lanes of them."""
    _, ps = scenes(0)
    R = 300
    o, d, tm = pt_rays(R, 5, [6, 1.6, -6])
    g = torch.Generator().manual_seed(2)
    u = PT.BounceUniforms(*(torch.rand((3,) + s, generator=g) for s in
                            ((R, 2), (R,), (R, 3), (R, 3), (R,))))
    cfg = RenderConfig(max_bounces=3)
    whole = PT.ray_color(ps, cfg, t(o), t(d), t(tm), uniforms=u)
    tiled = PT.ray_color_tiled(ps, cfg.replace(pt_tile_rays=128), t(o), t(d),
                               t(tm), uniforms=u)
    assert torch.equal(whole, tiled)


def test_render_pt_matches_jax_statistics():
    """``render_pt`` at 16x16, 4 spp, 4 bounces on scene 3, fed JAX's own
    draws (pathtracer.py:695-707; 1,024 paths, one tile), held with the
    statistic of ``test_pallas_pt.test_render_pt_kernel_backend_statistics``
    on both bodies."""
    js, ps = scenes(3)
    H = W = 16
    S, B = 4, 4
    eye, at = [0.0, -3.0, -4.0], [0.0, -3.0, 10.0]
    key = jax.random.PRNGKey(5)
    ref = np.asarray(JPT.render_pt(js, JaxConfig(max_bounces=B, pallas="off"),
                                   W, H, key=key, eye=jnp.array(eye),
                                   at=jnp.array(at), spp=S))
    k_pix, k_time, k_trace = jax.random.split(key, 3)
    samples = PT.PTSamples(
        jitter=t(jax.random.uniform(k_pix, (H, W, S, 2))),
        time=t(jax.random.uniform(k_time, (H, W, S))),
        uniforms=jax_uniforms(k_trace, H * W * S, ps.qlight_pos.shape[0], B))
    cfg = RenderConfig(max_bounces=B)
    for c in (cfg, cfg.replace(kernels="off")):
        img = PT.render_pt(ps, c, W, H, eye=eye, at=at, spp=S,
                           samples=samples).numpy()
        assert img.shape == (H, W, 3) and np.isfinite(img).all()
        assert (np.abs(img - ref) > 1e-3).mean() < 0.05
        assert abs(img.mean() - ref.mean()) < 5e-3


def test_render_pt_generator_runs_on_scene_device():
    _, ps = scenes(0)
    cfg = RenderConfig(max_bounces=3, pt_tile_rays=100)
    a = PT.render_pt(ps, cfg, 12, 8, torch.Generator().manual_seed(1),
                     eye=[6, 1.6, -6], at=[0, 0.5, 0], spp=2)
    b = PT.render_pt(ps, cfg, 12, 8, torch.Generator().manual_seed(1),
                     eye=[6, 1.6, -6], at=[0, 0.5, 0], spp=2)
    assert a.shape == (8, 12, 3) and a.device.type == "cpu"
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert float(a.std()) > 0.02


def test_config_defaults_match_jax():
    a, b = JaxConfig(), RenderConfig()
    assert (a.max_bounces, a.russian_roulette, a.pt_tile_rays) == (
        b.max_bounces, b.russian_roulette, b.pt_tile_rays)
    with pytest.raises(ValueError, match="pt_tile_rays"):
        RenderConfig(pt_tile_rays=-1)


def test_cli_pathtrace_writes_png(tmp_path, capsys):
    out = str(tmp_path / "pt.png")
    cli.main(["pathtrace", "--scene", "0", "--res", "12", "8", "--spp", "1",
              "--bounces", "2", "--device", "cpu", "-o", out])
    text = capsys.readouterr().out
    assert "Msamples/s" in text and "device=cpu" in text
    img = read_png(out)
    assert img.shape == (8, 12, 3) and img.std() > 0.02


def test_pt_kernels_refuse_cpu_tensors():
    _, ps = scenes(0)
    o, d, tm = (t(a) for a in pt_rays(8, 0, [6, 1.6, -6]))
    with pytest.raises(ValueError, match="CUDA tensors"):
        CP.pt_closest_kernel(ps, o, d, tm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        CP.pt_any_hit_kernel(ps, o, d, tm, 1.0)
    st = CP.bounce_state(o, d, tm)
    uni = torch.zeros((CP.UNIFORM_ROWS, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        CP.pt_bounce_kernel(ps, st, uni, True)
    with pytest.raises(ValueError, match="uniforms"):
        CP.pt_bounce(ps, st, uni[:3], True)
