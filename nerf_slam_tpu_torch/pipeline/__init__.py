from .module import PipelineModule, ModuleThread  # noqa: F401
from .modules import (DataModule, SlamModule, FusionModule,  # noqa: F401
                      EvalSink, DEVICE_LOCK)
from .runner import connect, run_parallel, run_sequential  # noqa: F401
