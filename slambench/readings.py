"""The readings each limit of ``correct`` is set from, several seeds of one
cell in one process (set-up is long; the imports are paid once)::

    python3 -m slambench.readings --workload kitti00.drive --seconds 20 \
        --seeds 11,12,13 --plant none,ba_skipped,fp8

For each planted fault (``none`` for sound runs, a name of
``slambench.faults.FAULTS``, or ``fp8`` for the control) and each seed, one
run of the cell as ``slambench.run`` makes it (the same set-up, window and
comparison; ``--seconds`` may be shorter than the benchmark's window, since
the comparison reads a fixed sample), and one JSON line: the seed, what was
planted, ``correct``, each compared number and the details.  The
benchmark's own runs never plant anything.  Exits 2 without a CUDA card."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from slambench import run  # noqa: E402  (sets the cache directories and threads)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="slambench.readings", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--plant", default="none", help="comma-separated: none, fp8, or names of faults.FAULTS")
    args = ap.parse_args(argv)
    import torch

    from slambench import faults, harness

    if not torch.cuda.is_available():
        print("slambench.readings: no CUDA device", file=sys.stderr)
        return 2
    loaded = harness.load_cell(run.ROOT, args.workload)
    for plant in args.plant.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            out = harness.run_cell(loaded, seed=seed, seconds=args.seconds, trace=False, device="cuda:0",
                                   t_start=t0, control="fp8" if plant == "fp8" else None,
                                   fault=faults.FAULTS[plant] if plant not in ("none", "fp8") else None)
            info = out["info"]
            print(json.dumps({"workload": args.workload, "seed": seed, "plant": plant, "correct": out["correct"],
                              "checks": {k: c["value"] for k, c in out["checks"].items()},
                              "detail": info["readings_detail"], "frames_done": info["frames_done"],
                              "keyframes": info["window_counters"]["keyframes"], "failed": out["failed"],
                              "sampled_frames": info["sampled_keyframes"],
                              "run_s": time.perf_counter() - t0}, default=float), flush=True)
            torch.cuda.empty_cache()
    bad = run.forbidden_modules()
    if bad:
        print(f"slambench.readings: the process holds {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
