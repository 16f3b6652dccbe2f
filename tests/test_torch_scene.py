"""Port scene layer vs the JAX package: builder, procedural scene, P3F
parser (with the skybox ``env`` command), packed object table, numpy
carry-over, and the path tracer's five scenes."""

import dataclasses

import numpy as np
import pytest
import torch

from distributionraytracer_tpu.scene import builder as jax_builder
from distributionraytracer_tpu.scene import load_p3f as jax_load_p3f
from distributionraytracer_tpu.scene import pt_scenes as jax_pt_scenes
from distributionraytracer_tpu.scene.procedural import (
    create_random_scene as jax_random_scene,
)
from distributionraytracer_tpu.scene.skybox import (
    load_skybox as jax_load_skybox,
)
from distributionraytracer_tpu_torch.scene import (
    SCENE_BUILDERS, PTScene, SceneBuilder, create_random_scene, load_p3f,
    load_skybox, parse_p3f, pt_scene_from_numpy, scene_from_numpy,
)
from distributionraytracer_tpu_torch.scene.types import SceneData

from torch_port_util import leaves_equal, to_port
from torch_scenes import synthetic_faces

torch.set_num_threads(1)


def _all_primitives(b):
    """Both builders get the same calls: every primitive and light kind."""
    b.set_camera([0, 1, 6], [0, 0, 0], [0, 1, 0], 45, 0.01, 20, 15, 0.5, 2)
    m0 = b.add_material([0.6, 0.6, 0.2], 0.8, [0.2, 0.2, 0.2], 0.0, 10, 0, 1)
    b.add_plane_hessian([0, 1, 0], 1.0)
    b.add_sphere([-0.8, 0, 0], 0.8)
    m1 = b.add_material([0.1, 0.9, 0.2], 0.0, [1, 1, 1], 0.5, 30, 1, 1.5)
    b.add_triangle([0, 0, 0], [1, 0, 0], [0, 1, 0.5], m1)
    b.add_box([1, -1, -1], [2, 0.5, 0], m0)
    b.add_plane_points([0, 0, -5], [1, 0, -5], [0, 1, -5])
    verts = np.array([[0, 2, 0], [1, 2, 0], [0, 3, 0], [1, 3, 1]], np.float32)
    b.add_triangles_bulk(verts, np.array([[0, 1, 2], [1, 3, 2]]))
    b.add_point_light([2, 4, 2], [1, 1, 1])
    b.add_quad_light([2, 4, 2], [1, 1, 1], [3, 4, 2], [2, 4, 3], 16)
    b.bg_color = np.array([0.1, 0.2, 0.4], np.float32)
    return b.build()


def test_builder_leaves_equal_jax():
    leaves_equal(_all_primitives(jax_builder.SceneBuilder()),
                 _all_primitives(SceneBuilder()))


@pytest.mark.parametrize("seed,res", [(0, (800, 600)), (3, (16, 12))])
def test_random_scene_leaves_equal_jax(seed, res):
    a = jax_random_scene(seed, *res)
    b = create_random_scene(seed, *res)
    leaves_equal(a, b)
    assert b.static.n_spheres == a.static.n_spheres


P3F_TEXT = """# every command the parser knows, except env
accel none
spp 4
camera eye 0 1 6 at 0 0 0 up 0 1 0 angle 45 hither 0.01
  resolution 20 15 aperture 0.5 focal 2
bclr 0.1 0.2 0.4
light punctual 2 4 2 1 1 1
light quad 2 4 2  1 1 1  3 4 2  2 4 3  16
mat 0.6 0.6 0.2 0.8 0.2 0.2 0.2 0.0 10 0 1
npl 0 1 0 1.0
pl 0 0 -5 1 0 -5 0 1 -5
s -0.8 0 0 0.8   # trailing comment
mat 0.1 0.9 0.2 0.0 1 1 1 0.5 30 1 1.5
p 3 0 0 0 1 0 0 0 1 0.5
box 1 -1 -1 2 0.5 0
mesh 4 2
0 2 0  1 2 0  0 3 0  1 3 1
1 2 3
2 4 3
mesh 3 1
0 0 1  1 0 1  0 1 1
-3 -2 -1
"""


def test_p3f_every_command_matches_jax(tmp_path):
    path = tmp_path / "all.p3f"
    path.write_text(P3F_TEXT)
    a = jax_load_p3f(str(path))
    b = parse_p3f(P3F_TEXT)
    leaves_equal(a, b)
    # 1-based faces of mesh 1 and negative faces of mesh 2
    assert b.static.n_triangles == 4
    np.testing.assert_array_equal(b.tri_v0[2].numpy(), [1, 2, 0])
    np.testing.assert_array_equal(b.tri_v0[3].numpy(), [0, 0, 1])


def test_p3f_refusals():
    with pytest.raises(FileNotFoundError, match="skybox dir"):
        parse_p3f(P3F_TEXT + "env no_such_skybox_dir\n")
    with pytest.raises(ValueError, match="unknown P3F command"):
        parse_p3f(P3F_TEXT + "teapot 1 2 3\n")
    with pytest.raises(ValueError, match="no camera"):
        parse_p3f("mat 1 1 1 1 0 0 0 0 1 0 1\ns 0 0 0 1\n")


@pytest.mark.parametrize("which", ["builder", "random"])
def test_packed_objects_equal_jax(which):
    a = (_all_primitives(jax_builder.SceneBuilder()) if which == "builder"
         else jax_random_scene(0, 16, 12))
    b = to_port(a)
    for x, y in zip(a.device_put().packed_objects(), b.packed_objects()):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_scene_from_numpy_round_trip():
    s = create_random_scene(1, 32, 24)
    leaves = {n: getattr(s, n).numpy() for n in SceneData._LEAF_NAMES}
    back = scene_from_numpy(leaves, dataclasses.asdict(s.static))
    for n in SceneData._LEAF_NAMES:
        assert torch.equal(getattr(s, n), getattr(back, n)), n
    assert back.static == s.static
    assert hash(back.static) == hash(s.static)
    with pytest.raises(ValueError, match="missing scene leaves"):
        scene_from_numpy({"sph_center": leaves["sph_center"]},
                         dataclasses.asdict(s.static))


def _write_skybox(sky_dir, seed=0):
    """Six small JPEG faces of unequal sizes, as the reference names them."""
    Image = pytest.importorskip("PIL.Image")
    sky_dir.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i, name in enumerate(["right", "left", "top", "bottom", "front",
                              "back"]):
        h, w = 4 + i, 9 - i
        px = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(px).save(sky_dir / f"{name}.jpg")


def test_load_skybox_and_p3f_env_match_jax(tmp_path):
    """``load_skybox`` and P3F ``env`` (the directory found one level above
    the scene file, as the reference finds it) give the JAX package's
    leaves."""
    _write_skybox(tmp_path / "sky")
    faces, res = load_skybox(str(tmp_path / "sky"))
    ref_faces, ref_res = jax_load_skybox(str(tmp_path / "sky"))
    assert faces.dtype == ref_faces.dtype and res.dtype == ref_res.dtype
    np.testing.assert_array_equal(faces, ref_faces)
    np.testing.assert_array_equal(res, ref_res)
    assert len(np.unique(res[:, 0])) == 6
    (tmp_path / "scenes").mkdir()
    path = tmp_path / "scenes" / "sky.p3f"
    path.write_text(P3F_TEXT + "env sky\n")
    a = jax_load_p3f(str(path))
    b = load_p3f(str(path))
    leaves_equal(a, b)
    assert b.static.has_skybox
    leaves_equal(a, parse_p3f(P3F_TEXT + "env sky\n",
                              str(tmp_path / "scenes")))


@pytest.mark.parametrize("si", sorted(SCENE_BUILDERS))
def test_pt_scene_leaves_equal_jax(si):
    """The path tracer's scenes, built by both packages (cubemap scenes with
    the same synthetic faces): every leaf bit-equal, same sky mode."""
    args = () if si == 0 else synthetic_faces(si)
    a = jax_pt_scenes.SCENE_BUILDERS[si](*args)
    b = SCENE_BUILDERS[si](*args)
    assert a.sky_mode == b.sky_mode
    for n in PTScene._LEAVES:
        x, y = np.asarray(getattr(a, n)), getattr(b, n).numpy()
        assert x.dtype == y.dtype, (n, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=n)
    T, S, M = (b.tri_v0.shape[0], b.sph_center.shape[0],
               b.msph_c0.shape[0])
    if si == 0:
        assert (T, S, M, b.mat_type.shape[0]) == (2, 78, 25, 104)
        assert (b.plight_pos.shape[0], b.qlight_pos.shape[0]) == (3, 0)
    else:
        assert 15 <= T + S + M <= 27 and b.qlight_pos.shape[0] == 1


def test_pt_scene_from_numpy_round_trip():
    s = SCENE_BUILDERS[3](*synthetic_faces(3))
    leaves = {n: getattr(s, n).numpy() for n in PTScene._LEAVES}
    back = pt_scene_from_numpy(leaves, s.sky_mode)
    assert back.sky_mode == s.sky_mode and back.device.type == "cpu"
    for n in PTScene._LEAVES:
        assert torch.equal(getattr(s, n), getattr(back, n)), n
    moved = back.to("cpu")
    assert moved is not back and torch.equal(moved.sky_faces, s.sky_faces)
    with pytest.raises(ValueError, match="missing path-tracer scene leaves"):
        pt_scene_from_numpy({"tri_v0": leaves["tri_v0"]}, s.sky_mode)
