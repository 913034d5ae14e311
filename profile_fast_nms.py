#!/usr/bin/env python3
"""Where the FAST+NMS kernel's time goes, on one NVIDIA GPU.

    python3 profile_fast_nms.py

Builds ``orb_slam2_ros2_tpu_torch/csrc/fast_nms.cu`` and prints:
  1. the card (nvidia-smi name, power limit, SM clock);
  2. the kernel's device time on the two KITTI pyramids of ``chip_smoke.py``
     (one launch, ``device_ms``), NMS on and off, and its SASS instruction
     mix (cuobjdump) per scored pixel;
  3. the throughput of the instruction kinds the kernel is made of, from
     probe kernels whose loops hold a fixed number of instructions of the
     kind per step (their SASS histograms are printed beside the rates, to
     check that count): lanes per clock per SM at the card's maximum SM
     clock, with the clock nvidia-smi reports right after the probes.

Needs nvcc (and cuobjdump beside it) and a CUDA device; exits non-zero
without one.  Writes its build products under ``build/profile/``.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import subprocess
import sys

import torch

import chip_smoke
from orb_slam2_ros2_tpu_torch import SLAMConfig
from orb_slam2_ros2_tpu_torch.ops import _build, fast

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "profile")
PROBES = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
// each step is two instructions of the kind (one for the three-input min)
template <int OP>
__device__ __forceinline__ unsigned step(unsigned a, unsigned x, unsigned y) {
  unsigned r;
  if (OP == 0) { asm volatile("add.f32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(x));
                 asm volatile("sub.f32 %0, %1, %2;" : "=r"(r) : "r"(r), "r"(y)); }
  if (OP == 1) { asm volatile("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(x));
                 asm volatile("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "r"(r), "r"(y)); }
  if (OP == 2) { asm volatile("min.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(x));
                 asm volatile("max.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(r), "r"(y)); }
  if (OP == 3) { __nv_bfloat162 v = __hmin2(__hmin2(*reinterpret_cast<__nv_bfloat162*>(&a),
                                                    *reinterpret_cast<__nv_bfloat162*>(&x)),
                                            *reinterpret_cast<__nv_bfloat162*>(&y));
                 r = *reinterpret_cast<unsigned*>(&v); }
  if (OP == 4) { asm volatile("min.f32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(x));
                 asm volatile("max.f32 %0, %1, %2;" : "=r"(r) : "r"(r), "r"(y)); }
  if (OP == 5) { asm volatile("prmt.b32 %0, %1, %2, 0x7632;" : "=r"(r) : "r"(a), "r"(x));
                 asm volatile("prmt.b32 %0, %1, %2, 0x5410;" : "=r"(r) : "r"(r), "r"(y)); }
  if (OP == 6) { asm volatile("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(x), "r"(y));
                 asm volatile("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(r), "r"(y), "r"(x)); }
  return r;
}
template <int OP>
__global__ void probe(unsigned* out, unsigned seed, int iters) {
  unsigned acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = seed * (threadIdx.x + 7 * i) | 0x3f800000u;
  const unsigned x = seed ^ 0x3f8f0000u, y = seed + 0x40000000u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = step<OP>(acc[i], x + i, y);
  }
  unsigned r = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) r ^= acc[i];
  if (r == seed) out[0] = r;
}
extern "C" int run(int op, void* out, int blocks, int iters, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto o = static_cast<unsigned*>(out);
  switch (op) {
    case 0: probe<0><<<blocks, 256, 0, st>>>(o, 12345u, iters); break;
    case 1: probe<1><<<blocks, 256, 0, st>>>(o, 12345u, iters); break;
    case 2: probe<2><<<blocks, 256, 0, st>>>(o, 12345u, iters); break;
    case 3: probe<3><<<blocks, 256, 0, st>>>(o, 12345u, iters); break;
    case 4: probe<4><<<blocks, 256, 0, st>>>(o, 12345u, iters); break;
    case 5: probe<5><<<blocks, 256, 0, st>>>(o, 12345u, iters); break;
    case 6: probe<6><<<blocks, 256, 0, st>>>(o, 12345u, iters); break;
  }
  return static_cast<int>(cudaGetLastError());
}
"""
# (name, instructions of the kind per step)
PROBES_RUN = [("FADD f32", 2), ("F2FP f32x2 -> bf16x2", 2), ("HMNMX2 bf16x2 min, max", 2),
              ("VHMNMX bf16x2 3-input min", 1), ("FMNMX f32 min, max", 2), ("PRMT", 2),
              ("IMAD", 2)]


def sass_histograms(source: str) -> dict:
    """{kernel name: Counter of SASS opcodes} of one CUDA source."""
    cubin = os.path.join(OUT, os.path.basename(source).replace(".cu", ".cubin"))
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-cubin", "-o", cubin, source], check=True)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        out[fn.splitlines()[0].strip()] = collections.Counter(
            m.group(1) for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", fn))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_fast_nms: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    sm_hz = float(card.split(",")[-1].split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[1/3] {card}, {sms} SMs")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    _, canvas, table = chip_smoke.k1_inputs(SLAMConfig(), gen)
    out = torch.empty(table.out_numel, dtype=torch.bfloat16, device="cuda")
    for nms in (True, False):
        ms = chip_smoke.device_ms(lambda: fast.fast_score_nms_pyramid(canvas, table, chip_smoke.FAST_TH,
                                                                      nms=nms, out=out))
        print(f"[2/3] fast_nms nms={nms}: {ms:.5f} ms for {table.out_numel} pixels, "
              f"{table.n_tiles} tiles of {fast.TILE_H}x{fast.TILE_W}")
    scored = table.n_tiles * (fast.TILE_H + 2) * (fast.TILE_W + 2)
    for name, ops in sass_histograms(str(_build.CSRC_DIR / "fast_nms.cu")).items():
        if "fast_nms_kernel" not in name:
            continue
        threads = 256
        print(f"[2/3] {name[-60:]}: {sum(ops.values())} SASS instructions (static; the tile's "
              f"code is unrolled), {sum(ops.values()) * threads / ((fast.TILE_H + 2) * (fast.TILE_W + 2)):.1f} "
              f"per scored pixel of a tile ({scored} scored pixels in all)")
        print("      " + ", ".join(f"{k}:{v}" for k, v in ops.most_common(24)))

    src = os.path.join(OUT, "probes.cu")
    with open(src, "w") as f:
        f.write(PROBES)
    so = os.path.join(OUT, "probes.so")
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sink = torch.zeros(4, dtype=torch.int32, device="cuda")
    blocks, iters = sms * 8, 4096
    hist = {int(re.search(r"probeILi(\d)E", k).group(1)): v for k, v in sass_histograms(src).items()}
    stream = torch.cuda.current_stream().cuda_stream
    for op, (name, per_step) in enumerate(PROBES_RUN):
        ms = chip_smoke.device_ms(lambda: lib.run(op, sink.data_ptr(), blocks, iters, stream), runs=5)
        lanes = blocks * 256 * iters * 8 * per_step / (ms * 1e-3) / sms / sm_hz
        print(f"[3/3] {name:28s} {lanes:6.1f} lanes/clock/SM ({ms:.4f} ms); probe SASS "
              f"{dict(hist[op].most_common(4))}")
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip()
    print(f"[3/3] SM clock after the probes: {clock}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
