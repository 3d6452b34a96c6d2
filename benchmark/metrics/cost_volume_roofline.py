"""The cost-volume stages' share of their roofline: K1's footprint a frame
(``work.cost_volume_bytes``) over the HBM's peak bytes/s, over the device
time a frame of the kernels in the ``cost_volume_{i}`` stages, in %."""


def read(rec):
    stages = rec.get("stage_kernel_s")
    w = rec.get("work", {})
    names = w.get("cost_volume_stages")
    if not stages or not names or not rec.get("units"):
        return None
    if not all(n in stages for n in names):
        return None
    t = sum(stages[n] for n in names) / rec["units"]
    if t <= 0:
        return None
    return 100.0 * w["cost_volume_bytes"] / w["peaks"]["hbm_bytes_per_s"] / t
