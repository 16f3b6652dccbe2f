from distributionraytracer_tpu_torch.scene.types import (  # noqa: F401
    SceneData,
    SceneStatic,
    CameraParams,
    scene_from_numpy,
    ACCEL_NONE,
    ACCEL_GRID,
    ACCEL_BVH,
    OBJ_SPHERE,
    OBJ_TRIANGLE,
    OBJ_PLANE,
    OBJ_BOX,
)
from distributionraytracer_tpu_torch.scene.p3f import load_p3f, parse_p3f  # noqa: F401
from distributionraytracer_tpu_torch.scene.builder import SceneBuilder  # noqa: F401
from distributionraytracer_tpu_torch.scene.procedural import create_random_scene  # noqa: F401
from distributionraytracer_tpu_torch.scene.pt_scenes import (  # noqa: F401
    PTScene,
    SCENE_BUILDERS,
    pt_scene_from_numpy,
)
from distributionraytracer_tpu_torch.scene.skybox import load_skybox  # noqa: F401
