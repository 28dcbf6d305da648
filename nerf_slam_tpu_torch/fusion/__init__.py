from .ngp import NGPConfig, PEField  # noqa: F401
from .nerf_fusion import NerfFusion, NerfFusionConfig, TrainSet  # noqa: F401
