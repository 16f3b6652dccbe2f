"""The program under test, ``distributionraytracer_tpu_torch``, as the
traffic kinds drive it: its scene built through its own ``SceneBuilder``
from a configuration's generator, its render configuration, and its
``SampleSet``.  Imported only inside a run, never by the reference."""

from __future__ import annotations

import importlib

from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import SampleSet
from distributionraytracer_tpu_torch.renderer import Renderer
from distributionraytracer_tpu_torch.scene.builder import SceneBuilder

__all__ = ["RenderConfig", "Renderer", "SampleSet", "generator", "scene",
           "render_config"]


def generator(cfg):
    """The configuration's scene generator module (``scenes/<name>.py``)."""
    return importlib.import_module("portbench.scenes." + cfg["generator"])


def scene(cfg):
    """The program's SceneData of the configuration (on the host)."""
    b = SceneBuilder()
    generator(cfg).build(b, cfg)
    return b.build()


def render_config(cfg, **kw):
    """The render configuration the cell states: depth, samples per pixel
    and the upstream shadow convention."""
    return RenderConfig(max_depth=cfg["max_depth"], spp=cfg["spp"],
                        shadow_mode=cfg["shadow_mode"]).replace(**kw)
