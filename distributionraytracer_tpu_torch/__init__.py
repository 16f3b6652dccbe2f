"""PyTorch/CUDA port of the distribution ray tracer.

The counterpart of ``distributionraytracer_tpu`` for one NVIDIA H100.  It
keeps that package's module layout and public names; plain code is torch,
and the Pallas kernels on the ported path are CUDA C++ kernels under
``csrc/``, built with ``nvcc`` at first use (``ops/build.py``).  Every
kernel has a plain torch version beside it that CPU tensors use.

Ported so far: the accel-NONE Whitted/distribution frame (P3F and built-in
scenes, AA, depth of field, motion blur, hard shadows, refraction with
Beer absorption, skybox, progressive accumulation, the ``render`` CLI) and
the GLSL-semantics path tracer (its five scenes, ``render_pt``, the
``pathtrace`` CLI).
"""

__version__ = "0.1.0"

from distributionraytracer_tpu_torch.config import RenderConfig  # noqa: F401,E402
from distributionraytracer_tpu_torch.integrator.pathtracer import (  # noqa: F401,E402
    render_pt,
    to_gamma,
)
