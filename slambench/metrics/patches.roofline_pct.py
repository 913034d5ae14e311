"""Kernel K2 (the 48x64 patch gather, ``csrc/patches.cu``): the least time
its job needs on the card (the f32 patches written and the canvas they cover
read, at the HBM peak; the mean over the checked keyframes) over its device
time a launch in the traced slice, in %."""

from slambench.roofline import least_seconds

KERNEL = "patches_kernel"


def read(rec):
    hits = [(n, us) for name, (n, us) in rec.get("kernels", {}).items() if KERNEL in name]
    work = rec.get("k2_work")
    if not hits or work is None:
        return None
    calls, total_us = sum(n for n, _ in hits), sum(us for _, us in hits)
    return 100.0 * least_seconds(work, rec["peaks"]) / (total_us / calls / 1e6) if total_us > 0 else None
