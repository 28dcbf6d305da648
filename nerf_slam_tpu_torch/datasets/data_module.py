"""Dataset factory, the port of the JAX package's
``datasets/data_module.py``.  Only the synthetic room is ported; the
other datasets wait for the ROADMAP.md module "The other datasets and
utils"."""
from __future__ import annotations

from typing import Optional

_NOT_PORTED = ("nerf", "replica", "tum", "euroc", "realsense")


def build_dataset(dataset_name: str, dataset_dir: Optional[str] = None,
                  **kw):
    """The dataset ``dataset_name`` names.  "synthetic" takes the
    ``SyntheticConfig`` fields among ``kw`` and ignores the rest."""
    if dataset_name == "synthetic":
        from .synthetic import SyntheticConfig, SyntheticDataset
        cfg_kw = {k: v for k, v in kw.items()
                  if k in SyntheticConfig.__dataclass_fields__}
        return SyntheticDataset(SyntheticConfig(**cfg_kw))
    if dataset_name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset {dataset_name!r} is not ported yet: ROADMAP.md, "
            f"module The other datasets and utils")
    raise ValueError(f"unknown dataset {dataset_name!r}")
