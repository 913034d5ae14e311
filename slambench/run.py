"""The port's benchmark, one run of one cell, from the root of a checkout::

    python3 -m slambench.run --workload kitti00.drive --seed 7 --seconds 30 --trace 0

Loads the cell named in ``BENCHMARK.json``, sets up (the stream rendered on
the card, ``SLAM`` built, the warm-up frames tracked), drives
``SLAM.track()`` in its pipelined mode for ``--seconds``, then checks what
the window produced against the plain reference (``slambench/reference``).
Prints an ``info`` line, then as its last line one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
last, ``checks``, each compared number beside its limit; the same numbers
close standard error.  Exits 2 without a result where no CUDA card is
available, and 3 where the process holds JAX or the JAX package once the
window has closed.

``--control fp8`` puts the reference computed in float8 in the program's
place (the comparison has to fail); the benchmark's own runs never pass it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
# one process, few threads: the host's intra-op pools stay out of the loop's way
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam2_ros2_tpu")


def forbidden_modules(modules=None) -> list:
    """Top-level names (the part before the first dot, compared whole) of
    loaded modules that the run may not hold."""
    tops = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="slambench.run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8",), default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def result_line(out: dict, device_kind: str, count: int, trace: bool) -> dict:
    """The contract's last line, ``checks`` last."""
    device = {"platform": "gpu", "kind": device_kind, "count": count,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if trace and "busy_s" in out:
        device.update(busy_s=out["busy_s"], window_s=out["trace_window_s"])
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device}
    if trace and "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from slambench import harness, timing

    loaded = harness.load_cell(ROOT, args.workload)
    chips = int(loaded["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slambench: the cell needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    out = harness.run_cell(loaded, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                           device="cuda:0", t_start=T_START, control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"slambench: the process holds {bad} after the window", file=sys.stderr)
        return 3
    info = dict(out["info"], workload=args.workload, seed=args.seed, card=timing.gpu_line(),
                control=args.control, memory_peak_bytes=out["memory_peak_bytes"])
    print(json.dumps({"slambench_info": info}, default=float), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result_line(out, torch.cuda.get_device_name(0), chips, bool(args.trace))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
