from . import se3, camera, upsample  # noqa: F401
