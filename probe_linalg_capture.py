#!/usr/bin/env python3
"""Which decompositions of the relocalization cascade synchronise with the
host or refuse a CUDA-graph capture, and what their replacements cost, on
one NVIDIA GPU.

    python3 probe_linalg_capture.py

For each operation, at the shapes the EPnP RANSAC of a LOST frame gives it
(5 candidate slots × 64 hypotheses): the ``torch.linalg`` calls the
cascade made before it became a graph (``eigh`` of the 3×3 covariance,
``svd`` of the 12×12 M, ``pinv`` of the 6×3 and 6×5 β systems), a
``torch.rand`` from a custom ``torch.Generator``, and the port's
replacements (``linalg_small.jacobi_svd`` on the centred 6×3 set and, in
float64, on M; ``linalg_small.lstsq_min_norm`` on the β systems).  Each
runs in a process of its own (a failed capture can leave the context
unusable) and prints one JSON line: its ms (10 calls between one CUDA event
pair, after a warm-up call), whether it synchronises under
``torch.cuda.set_sync_debug_mode("error")``, and whether a capture and one
replay succeed.  Exits non-zero without a CUDA device, or when a
replacement synchronises or fails to capture.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

SHAPE = (5, 64)   # candidate slots × RANSAC hypotheses
OPS = {
    "eigh_3x3": ("linalg", "torch.linalg.eigh(C3)"),
    "svd_12x12": ("linalg", "torch.linalg.svd(M12, full_matrices=True).Vh"),
    "pinv_6x3": ("linalg", "torch.linalg.pinv(L63, rtol=7.2e-7)"),
    "pinv_6x5": ("linalg", "torch.linalg.pinv(L65, rtol=7.2e-7)"),
    "rand_generator": ("linalg", "torch.rand((*SHAPE, 2048), generator=G, device='cuda')"),
    "jacobi_svd_6x3": ("port", "jacobi_svd(P63)"),
    "jacobi_svd_12x12_f64": ("port", "jacobi_svd(M12.double())"),
    "lstsq_min_norm_6x3": ("port", "lstsq_min_norm(L63, r6, 7.2e-7)"),
    "lstsq_min_norm_6x5": ("port", "lstsq_min_norm(L65, r6, 7.2e-7)"),
}


def one(name: str) -> dict:
    from orb_slam2_ros2_tpu_torch.solvers.linalg_small import jacobi_svd, lstsq_min_norm

    torch.manual_seed(0)

    def rnd(*shape):
        return torch.randn(*SHAPE, *shape, device="cuda")

    P63 = rnd(6, 3)
    env = dict(torch=torch, SHAPE=SHAPE, jacobi_svd=jacobi_svd, lstsq_min_norm=lstsq_min_norm,
               C3=P63.transpose(-1, -2) @ P63, P63=P63, M12=rnd(12, 12), L63=rnd(6, 3), L65=rnd(6, 5),
               r6=rnd(6), G=torch.Generator(device="cuda"))
    env["G"].manual_seed(3)
    fn = eval("lambda: " + OPS[name][1], env)
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(10):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    out = dict(op=name, kind=OPS[name][0], ms=ev[0].elapsed_time(ev[1]) / 10)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        out["syncs"] = False
    except RuntimeError as e:
        out.update(syncs=True, sync_error=str(e)[:120])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    try:
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(g):
            fn()
        g.replay()
        torch.cuda.synchronize()
        out["captures"] = True
    except RuntimeError as e:
        out.update(captures=False, capture_error=str(e)[:160])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_linalg_capture.py needs a CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) > 1:
        print(json.dumps(one(sys.argv[1])), flush=True)
        return 0
    bad = []
    for name, (kind, _) in OPS.items():
        r = subprocess.run([sys.executable, __file__, name], capture_output=True, text=True, timeout=300)
        line = r.stdout.strip().splitlines()[-1] if r.returncode == 0 and r.stdout.strip() else None
        print(line or json.dumps(dict(op=name, rc=r.returncode, stderr=r.stderr[-600:])), flush=True)
        res = json.loads(line) if line else {}
        if kind == "port" and (res.get("syncs", True) or not res.get("captures", False)):
            bad.append(name)
    print(json.dumps(dict(replacements_that_sync_or_refuse_capture=bad)), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
