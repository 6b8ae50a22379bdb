"""fast_lio_sam_qn_tpu_torch — the PyTorch + CUDA port of fast_lio_sam_qn_tpu.

The JAX package (``fast_lio_sam_qn_tpu``) is the reference; this package
mirrors its layout so each counterpart is easy to find:

- ``ops``     — SE(3) math, small linear algebra, voxel downsampling, kNN,
                streaming radius-FPFH, Quatro, Nano-GICP.
- ``models``  — the keyframe store, the loop-closure module and the
                pose-graph pipeline.
- ``utils``   — configuration, the scan simulator, trajectory evaluation
                and stage timers (host-side, numpy).
- ``csrc``    — hand-written CUDA C++ kernels for Hopper (``sm_90a``), built
                at first use by ``kernels.py`` and bound with ``ctypes``.
- ``convert`` — numpy -> torch state conversion (clouds, poses, keyframes).

Every function takes its tensors' device from its inputs; nothing here picks
a device for the caller.  Kernel wrappers take their plain PyTorch version
only for CPU tensors; on a CUDA tensor they launch the kernel or raise.

The port imports nothing of the JAX package: the host-side helpers it needs
are its own, in ``utils``.
"""
import torch

# TF32 keeps ~10 mantissa bits: the same failure class as the TPU's bf16
# matmul passes, which flipped 55% of nearest-neighbour picks on world
# coordinates (fast_lio_sam_qn_tpu/ops/pallas_knn.py:86-90).  Distances,
# moments and the GICP normal equations all need full fp32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
