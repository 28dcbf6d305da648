from .frontend import (RaftVisualFrontend, FrontendConfig,  # noqa: F401
                       KeyframeState, EdgeState)
from . import graph  # noqa: F401
