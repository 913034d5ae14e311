"""Batched keypoint-patch extraction from the pyramid canvas.

Port of ``orb_slam2_ros2_tpu/ops/pallas_patches.py``.  One 48×64 window per
keypoint serves orientation, the folded-blur BRIEF sampling and the stereo
SAD refinement.  ``extract_patches_48x64`` launches the hand-written kernel
``csrc/patches.cu`` on a CUDA tensor and runs the plain gather
``extract_patches_plain`` on a CPU tensor; the two are bit-identical.

The window origin keeps the TPU kernel's clamp bounds (``H − 56``, ``W − 256``,
from its aligned DMA window): they define which pixels a clamped patch holds.
"""

from __future__ import annotations

import torch

from . import _build

PATCH_ROWS = 48
PATCH_COLS = 64
CENTER = 22          # patch centre offset (both axes)
_WIN_ROWS = PATCH_ROWS + 8     # the TPU DMA window the clamp is defined by
_WIN_COLS = PATCH_COLS + 192

# kernel launches made by extract_patches_48x64 (one per call on a CUDA tensor;
# a call inside a CUDA-graph capture records the kernel and counts nothing)
patch_launches = 0


def _origins(centers_yx: torch.Tensor, h: int, w: int):
    """Window origins: the DMA-window clip, then dynamic_slice's clamp."""
    y = torch.clamp(torch.clamp(centers_yx[:, 0] - CENTER, 0, h - _WIN_ROWS), 0, h - PATCH_ROWS)
    x = torch.clamp(torch.clamp(centers_yx[:, 1] - CENTER, 0, w - _WIN_COLS), 0, w - PATCH_COLS)
    return y, x


def extract_patches_plain(canvas: torch.Tensor, centers_yx: torch.Tensor) -> torch.Tensor:
    """[H, W] canvas + int[N, 2] (y, x) centres → f32[N, 48, 64] patches."""
    h, w = canvas.shape
    y, x = _origins(centers_yx.long(), h, w)
    rows = y[:, None, None] + torch.arange(PATCH_ROWS, device=canvas.device)[None, :, None]
    cols = x[:, None, None] + torch.arange(PATCH_COLS, device=canvas.device)[None, None, :]
    return canvas[rows, cols].float()


def extract_patches_48x64(canvas: torch.Tensor, centers_yx: torch.Tensor,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel on a CUDA canvas (bf16 [H, W], int32 [N, 2] centres), the
    plain gather on a CPU canvas; anything else raises.  Writes into ``out``
    (f32 [N, 48, 64]) when given."""
    if canvas.device.type == "cpu":
        p = extract_patches_plain(canvas, centers_yx)
        return p if out is None else out.copy_(p)
    if canvas.device.type != "cuda":
        raise ValueError(f"extract_patches_48x64: unsupported device {canvas.device}")
    h, w = canvas.shape if canvas.dim() == 2 else (0, 0)
    if (canvas.dtype != torch.bfloat16 or canvas.dim() != 2 or not canvas.is_contiguous()
            or h < PATCH_ROWS or w < PATCH_COLS):
        raise ValueError(
            f"patches kernel takes a contiguous bf16 [H>=48, W>=64] canvas, got "
            f"{canvas.dtype} {tuple(canvas.shape)} contiguous={canvas.is_contiguous()}"
        )
    if (centers_yx.dtype != torch.int32 or centers_yx.dim() != 2 or centers_yx.shape[1] != 2
            or not centers_yx.is_contiguous() or centers_yx.device != canvas.device):
        raise ValueError(
            f"patches kernel takes contiguous int32 [N, 2] centres on {canvas.device}, got "
            f"{centers_yx.dtype} {tuple(centers_yx.shape)} on {centers_yx.device}"
        )
    n = centers_yx.shape[0]
    shape = (n, PATCH_ROWS, PATCH_COLS)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=canvas.device)
    elif out.shape != shape or out.dtype != torch.float32 or out.device != canvas.device \
            or not out.is_contiguous():
        raise ValueError(f"extract_patches_48x64: out must be a contiguous f32 {shape} tensor")
    lib = _build.load("patches")
    with torch.cuda.device(canvas.device):
        rc = lib.extract_patches_bf16(
            canvas.data_ptr(), centers_yx.data_ptr(), out.data_ptr(), n, h, w,
            torch.cuda.current_stream(canvas.device).cuda_stream,
        )
    _build.check_launch(rc, "patches")
    if not torch.cuda.is_current_stream_capturing():
        global patch_launches
        patch_launches += 1
    return out
