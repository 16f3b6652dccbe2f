"""The audit of the JAX package's public names against the port's: every
module-level function, class, constant and public method of
``distributionraytracer_tpu`` has its namesake in the port's module of the
same path, apart from the names listed here with the reason.  Also holds
the small public names the audit found missing against the JAX package."""

import ast
import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributionraytracer_tpu.ops import common as jax_common
from distributionraytracer_tpu.ops import sampling as jax_sampling
from distributionraytracer_tpu.scene import types as jax_types
from distributionraytracer_tpu_torch.ops import common
from distributionraytracer_tpu_torch.ops import sampling
from distributionraytracer_tpu_torch.scene import types

from test_whitted import small_scene
from torch_port_util import to_port

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "distributionraytracer_tpu"
PORT_PKG = "distributionraytracer_tpu_torch"

# JAX modules whose port has another name or none, and why
MODULES_ELSEWHERE = {
    "ops/pallas_intersect.py": "K1/K2: ops/cuda_intersect.py, csrc/",
    "ops/pallas_whitted.py": "K3: ops/cuda_whitted.py, csrc/",
    "ops/pallas_pt.py": "K4-K6: ops/cuda_pt.py, csrc/",
    "accel/pallas_packet.py": "K7: accel/cuda_packet.py, cuda_bvh.py",
    "accel/pallas_bvh.py": "K8: accel/cuda_bvh.py",
    "accel/pallas_grid.py": "K3 grid mode and the emulation: cuda_grid.py",
    "accel/pallas_binned.py": "K9/K10: accel/cuda_binned.py",
    "native/__init__.py": "the port's own ctypes binding: native.py",
    "oracle/__init__.py": "the NumPy oracle, shared with the tests",
    "oracle/oracle.py": "the NumPy oracle, shared with the tests",
}
# public names with no namesake in the port's module, and why
NAMES_ELSEWHERE = {
    "integrator/whitted.py": {
        "compacting_intersectors": "compact_lanes is not ported: the "
                                   "kernels compact their own lanes"},
    "parallel/mesh.py": {
        "ensure_devices": "XLA's virtual CPU devices: a gloo group is the "
                          "CPU mesh",
        "make_device_mesh": "make_row_mesh over torch.distributed"},
    "scene/types.py": {
        "SceneData.device_put": "SceneData.to(device)",
        "SceneData.tree_flatten": "a JAX pytree hook",
        "SceneData.tree_unflatten": "a JAX pytree hook"},
    "scene/pt_scenes.py": {
        "PTScene.device_put": "PTScene.to(device)",
        "PTScene.tree_flatten": "a JAX pytree hook",
        "PTScene.tree_unflatten": "a JAX pytree hook"},
    "integrator/render.py": {
        "SampleSet.tree_flatten": "a JAX pytree hook",
        "SampleSet.tree_unflatten": "a JAX pytree hook"},
}


def public_names(path):
    """Module-level functions, classes and constants, and classes' public
    methods, of the source at ``path``."""
    out = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, ast.FunctionDef)
                        and not m.name.startswith("_")}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets
                    if isinstance(t, ast.Name) and not t.id.startswith("_")}
    return out


def jax_modules():
    root = os.path.join(REPO, JAX_PKG)
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), root)


def test_every_jax_public_name_has_its_namesake_in_the_port():
    missing = {}
    for rel in jax_modules():
        if rel in MODULES_ELSEWHERE or rel == "__main__.py":
            continue  # __main__ runs the CLI when imported
        dotted = rel[:-3].replace(os.sep, ".")
        mod = importlib.import_module(
            PORT_PKG if dotted == "__init__"
            else PORT_PKG + "." + dotted.removesuffix(".__init__"))
        allowed = NAMES_ELSEWHERE.get(rel, {})
        for name in sorted(public_names(os.path.join(REPO, JAX_PKG, rel))):
            obj = mod
            for part in name.split("."):
                obj = getattr(obj, part, None)
            if obj is None and name not in allowed:
                missing.setdefault(rel, []).append(name)
            assert obj is None or name not in allowed, (rel, name)
    assert not missing, missing


def test_scene_static_has_dof():
    scene = small_scene()
    for ratio in (0.0, 0.5):
        st = dataclasses.replace(scene.static, aperture_ratio=ratio)
        ported = to_port(scene).static
        ported = dataclasses.replace(ported, aperture_ratio=ratio)
        assert ported.has_dof == st.has_dof == (ratio != 0.0)
    assert (types.LIGHT_PUNCTUAL, types.LIGHT_QUAD) == (
        jax_types.LIGHT_PUNCTUAL, jax_types.LIGHT_QUAD)


def test_u8fromfloat_matches_jax():
    x = np.concatenate([np.linspace(0.0, 1.1, 1001, dtype=np.float32),
                        np.float32([254.5 / 255.99, 255.0 / 255.99, 1.0])])
    ref = np.asarray(jax_common.u8fromfloat(jnp.asarray(x)))
    got = common.u8fromfloat(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("fn", ["unit_sphere", "unit_vector"])
def test_ball_samples_match_jax(fn, monkeypatch):
    """The same uniforms through both packages' formulas: the port's draw
    from a generator is fed to the JAX function in place of its own."""
    shape = (64, 5)
    g = torch.Generator().manual_seed(11)
    got = getattr(sampling, fn)(g, shape).numpy()
    h = sampling.uniform(torch.Generator().manual_seed(11),
                         shape + (3,)).numpy()
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, s: jnp.asarray(h.reshape(s)))
    ref = np.asarray(getattr(jax_sampling, fn)(jax.random.PRNGKey(0),
                                               shape))
    assert got.shape == shape + (3,)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    r = np.linalg.norm(got, axis=-1)
    assert (r <= 1.0 + 1e-6).all()
    if fn == "unit_vector":
        np.testing.assert_allclose(r, 1.0, rtol=1e-6)
