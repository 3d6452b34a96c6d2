"""Device ms a frame of the kernels launched in the depth-regression
stages (``depth_{i}``: K4, between each level's ``cost_reg_{i}`` and
``depth_{i}`` marks), summed over the cascade's levels."""


def read(rec):
    stages = rec.get("stage_kernel_s")
    levels = rec.get("work", {}).get("cost_reg_stages")
    if not stages or not levels or not rec.get("units"):
        return None
    names = [f"depth_{i}" for i in range(len(levels))]
    if not all(n in stages for n in names):
        return None
    return sum(stages[n] for n in names) / rec["units"] * 1e3
