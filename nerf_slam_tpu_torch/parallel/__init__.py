"""Edge-sharded tracking and data-parallel mapping over several devices."""
from . import mapping, tracking  # noqa: F401
