"""PyTorch/CUDA port of the distribution ray tracer.

The counterpart of ``distributionraytracer_tpu`` for one NVIDIA H100.  It
keeps that package's module layout and public names; plain code is torch,
and the Pallas kernels on the ported path are CUDA C++ kernels under
``csrc/``, built with ``nvcc`` at first use (``ops/build.py``).  Every
kernel has a plain torch version beside it that CPU tensors use.

Ported: everything the JAX package does -- P3F and built-in scenes; the
Whitted/distribution ray tree (AA, depth of field, motion blur, hard and
soft shadows, refraction with Beer absorption, skybox); the GLSL-semantics
path tracer (its five scenes, ``render_pt``); uniform-grid and SAH-BVH
acceleration (``renderer.py``); gradients through the render
(``parallel.mesh.accel_intersectors``, the soft estimators); pixel-row
sharding over ``torch.distributed`` (``parallel/mesh.py``); progressive
accumulation with checkpoints; the browser viewer (``viewer.py``) and the
``render``, ``pathtrace`` and ``view`` CLI (``cli.py``).
"""

__version__ = "0.1.0"

from distributionraytracer_tpu_torch.config import RenderConfig  # noqa: F401,E402
from distributionraytracer_tpu_torch.integrator.pathtracer import (  # noqa: F401,E402
    render_pt,
    to_gamma,
)
