"""Hamming distance between ORB descriptors as one matrix product (port of
``orb_slam2_ros2_tpu/ops/hamming.py``).

Each 256-bit descriptor unpacks to a ±1 vector, and
``dot(a, b) = 256 − 2·hamming(a, b)`` (reference: src/ORBMatcher.cc:941-956
computes one pair at a time).  The product is in f32: every partial sum is an
integer of magnitude ≤ 256, so it is exact in any order.
"""

from __future__ import annotations

import torch

BITS = 256
WORDS = 8


def unpack_signs(desc: torch.Tensor) -> torch.Tensor:
    """int32[..., 8] packed descriptors → f32[..., 256] in {+1, −1}.
    ``(d >> s) & 1`` on int32 reads bit s of the uint32 word, sign bit included."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., :, None] >> shifts) & 1  # [..., 8, 32]
    bits = bits.reshape(*desc.shape[:-1], BITS)
    return 1.0 - 2.0 * bits.float()


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Pairwise distances int32[N, M] (batched over leading dims) from packed
    int32[..., N, 8] × int32[..., M, 8]."""
    dot = unpack_signs(desc_a) @ unpack_signs(desc_b).transpose(-1, -2)
    return ((BITS - dot) * 0.5).to(torch.int32)


def hamming_pairs(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance int32[...] between aligned packed descriptor rows
    int32[..., 8].  The XOR is counted byte by byte on a uint8 view: a shift
    of an int32 word with its sign bit set would carry the sign down."""
    x = (desc_a ^ desc_b).contiguous().view(torch.uint8)   # [..., 32]
    bits = sum((x >> k) & 1 for k in range(8))              # uint8 counts ≤ 8
    return bits.sum(dim=-1, dtype=torch.int32)
