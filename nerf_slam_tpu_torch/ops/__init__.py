from . import corr, corr_lookup  # noqa: F401
