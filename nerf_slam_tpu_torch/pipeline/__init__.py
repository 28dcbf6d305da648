from ..utils.runtime import DEVICE_LOCK  # noqa: F401
from .module import PipelineModule, ModuleThread  # noqa: F401
from .modules import (DataModule, SlamModule, FusionModule,  # noqa: F401
                      GuiModule, EvalSink)
from .runner import connect, run_parallel, run_sequential  # noqa: F401
