"""Device ms a frame of the kernels launched in the 3D CNN stages
(``cost_reg_{i}``), summed over the cascade's levels."""


def read(rec):
    stages = rec.get("stage_kernel_s")
    names = rec.get("work", {}).get("cost_reg_stages")
    if not stages or not names or not rec.get("units"):
        return None
    if not all(n in stages for n in names):
        return None
    return sum(stages[n] for n in names) / rec["units"] * 1e3
