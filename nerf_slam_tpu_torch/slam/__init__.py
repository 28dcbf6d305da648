from .meta_slam import SLAM, VioSLAM  # noqa: F401
from .imu import (PreintegratedImuMeasurements, ImuFactor,  # noqa: F401
                  BiasBetweenFactor, NavState, ImuBias,
                  PreIntegrationInertialFrontend)
