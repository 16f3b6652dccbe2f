"""The frozen scene generators build the scenes the program's own
generators build, and the reference records the same arrays."""

import importlib.util
import os

import numpy as np
import torch

from portbench import harness, program
from portbench.reference import scene as rscene

from distributionraytracer_tpu_torch.scene.builder import SceneBuilder
from distributionraytracer_tpu_torch.scene.procedural import (
    create_random_scene,
)
from distributionraytracer_tpu_torch.scene.types import SceneData


def _test_scenes():
    path = os.path.join(harness.ROOT, "tests", "torch_scenes.py")
    spec = importlib.util.spec_from_file_location("torch_scenes_copy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same(a, b):
    assert a.static == b.static
    for n in SceneData._LEAF_NAMES:
        x, y = getattr(a, n), getattr(b, n)
        assert x.shape == y.shape and torch.equal(x, y), n


def test_rtow_final_is_create_random_scene_0():
    cfg = harness.load_json("configs", "rtow_final.json")
    _same(program.scene(cfg), create_random_scene(0, cfg["res_x"],
                                                  cfg["res_y"]))


def test_dragon_mesh_is_the_tests_mesh_scene():
    cfg = harness.load_json("configs", "dragon_mesh100k_bvh.json")
    want = _test_scenes().mesh_scene(SceneBuilder, n_tri=cfg["n_triangles"],
                                     res=(cfg["res_x"], cfg["res_y"]),
                                     seed=cfg["scene_seed"])
    _same(program.scene(cfg), want)
    assert want.static.n_objects == cfg["objects"]


def test_the_reference_records_the_same_arrays():
    for name in ("rtow_final", "dragon_mesh100k_bvh"):
        cfg = harness.load_json("configs", name + ".json")
        if name.startswith("dragon"):
            cfg = dict(cfg, n_triangles=2000)
        sc, rs = program.scene(cfg), rscene.ref_scene(cfg, "cpu")
        sph = np.array(sc.static.obj_types) == 0
        assert torch.equal(rs.sph_c, sc.sph_center)
        assert torch.equal(rs.sph_r, sc.sph_radius)
        assert rs.sph_gid.tolist() == np.nonzero(sph)[0].tolist()
        assert torch.equal(rs.tri_v0, sc.tri_v0)
        assert torch.equal(rs.tri_e1, sc.tri_e1)
        assert torch.equal(rs.tri_e2, sc.tri_e2)
        assert torch.equal(rs.cd, sc.mat_cd) and torch.equal(rs.ks, sc.mat_ks)
        assert torch.equal(rs.lights, sc.light_pos)
        assert torch.equal(rs.eye, sc.cam_eye)
        assert rs.n_obj == sc.static.n_objects
