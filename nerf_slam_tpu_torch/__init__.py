"""nerf_slam_tpu_torch: the PyTorch/CUDA port of nerf_slam_tpu (NVIDIA
Hopper).  Plain tensor code is PyTorch; the TPU kernels of the tracking
hot loop are hand-written CUDA kernels under ops/csrc.  Entry points run
on CUDA unless the caller passes ``device="cpu"``."""

__version__ = "0.1.0"
