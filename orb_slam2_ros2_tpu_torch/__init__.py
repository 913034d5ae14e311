"""PyTorch + CUDA port of ``orb_slam2_ros2_tpu``.

The JAX package is the reference this package is held against; this one runs
stereo and RGB-D SLAM — tracking (synchronous or pipelined, the frame program
replayed as a CUDA graph), keyframe mapping with local BA, loop closing, map
save/load and relocalization in a saved map, and multi-device operation (the
solvers sharded over a device mesh, the tracker/mapper split, several
processes; ``parallel/``) — on NVIDIA GPUs, with the two TPU kernels of that
path replaced by CUDA C++ kernels written for Hopper (``csrc/``).
``entry.entry()`` returns the frame program and example inputs,
``entry.dryrun_multichip`` runs the multi-device paths.
It imports torch and numpy only — never JAX.
"""

import torch as _torch

# Precision policy, the counterpart of ``jax_default_matmul_precision=highest``
# in the JAX package: SLAM geometry (pose-chain 4×4 products, 6×6 normal
# equations with entries ~fx²) cannot survive TF32 or reduced-precision bf16
# reductions.  Deliberately-bf16 stages upcast to f32 explicitly.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
_torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

from .config import SLAMConfig  # noqa: E402,F401

__version__ = "0.1.0"
