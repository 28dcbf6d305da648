from .layers import BasicEncoder, ResidualBlock, instance_norm  # noqa: F401
from .update import ConvGRU, GraphAgg, UpdateModule, DroidNet  # noqa: F401
from .convert import (flax_to_state_dict, load_flax_weights,  # noqa: F401
                      state_dict_to_flax)
