from .evaluation import ate_rmse, umeyama_alignment  # noqa: F401
