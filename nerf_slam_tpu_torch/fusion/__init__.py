from .hashgrid import HashGridConfig  # noqa: F401
from .ngp import (NGPConfig, NGPField, PEField, init_ngp,  # noqa: F401
                  load_ngp_params)
from .nerf_fusion import NerfFusion, NerfFusionConfig, TrainSet  # noqa: F401
from .tsdf_fusion import TsdfFusion, TsdfFusionConfig  # noqa: F401
