"""Kernel K1 (FAST + 3x3 NMS over every pyramid level, ``csrc/fast_nms.cu``):
the least time its job needs on the card (operations at the f32 peak or
bytes at the HBM peak, counted from the configuration's pyramid shapes) over
its device time a launch in the traced slice, in %."""

from slambench.roofline import least_seconds

KERNEL = "fast_nms_kernel"


def read(rec):
    hits = [(n, us) for name, (n, us) in rec.get("kernels", {}).items() if KERNEL in name]
    work = rec.get("k1_work")
    if not hits or work is None:
        return None
    calls, total_us = sum(n for n, _ in hits), sum(us for _, us in hits)
    return 100.0 * least_seconds(work, rec["peaks"]) / (total_us / calls / 1e6) if total_us > 0 else None
