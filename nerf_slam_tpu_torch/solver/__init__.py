from . import dba  # noqa: F401
