"""Dataset factory, the port of the JAX package's
``datasets/data_module.py``, with the same dispatch: a ``None``
``dataset_dir`` means the synthetic room whatever the name; the file
loaders take ``initial_k``, ``final_k``, ``img_stride`` and ``buffer``
from ``kw``; EuRoC also takes ``stereo`` and ``target_hw`` (or
``height``/``width``); RealSense takes ``buffer`` alone."""
from __future__ import annotations

from typing import Optional


def build_dataset(dataset_name: str, dataset_dir: Optional[str] = None,
                  **kw):
    """The dataset ``dataset_name`` names.  The synthetic room takes the
    ``SyntheticConfig`` fields among ``kw`` and ignores the rest."""
    if dataset_name == "synthetic" or dataset_dir is None:
        from .synthetic import SyntheticConfig, SyntheticDataset
        cfg_kw = {k: v for k, v in kw.items()
                  if k in SyntheticConfig.__dataclass_fields__}
        return SyntheticDataset(SyntheticConfig(**cfg_kw))
    loader_kw = {k: v for k, v in kw.items()
                 if k in ("initial_k", "final_k", "img_stride", "buffer")}
    if dataset_name == "nerf":
        from .nerf_dataset import NeRFDataset
        return NeRFDataset(dataset_dir, **loader_kw)
    if dataset_name == "replica":
        from .replica_dataset import ReplicaDataset
        return ReplicaDataset(dataset_dir, **loader_kw)
    if dataset_name == "tum":
        from .tum_dataset import TumDataset
        return TumDataset(dataset_dir, **loader_kw)
    if dataset_name == "euroc":
        from .euroc_dataset import EurocDataset
        if "target_hw" in kw:
            loader_kw["target_hw"] = kw["target_hw"]
        elif "height" in kw and "width" in kw:
            loader_kw["target_hw"] = (kw["height"], kw["width"])
        return EurocDataset(dataset_dir, stereo=kw.get("stereo", False),
                            **loader_kw)
    if dataset_name == "realsense":
        from .realsense_dataset import RealSenseDataset
        return RealSenseDataset(buffer=kw.get("buffer", 512))
    raise ValueError(f"unknown dataset {dataset_name!r}")
