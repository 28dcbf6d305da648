from .synthetic import SyntheticDataset, SyntheticConfig  # noqa: F401
from .base import (Dataset, CameraCalibration, PinholeCameraModel,  # noqa
                   RadTanDistortionModel, ImuCalibration, Resolution)
