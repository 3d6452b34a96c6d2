"""Device ms a step of the kernels launched in the optimizer phase
(between the step's ``backward`` and ``optimizer`` marks: the gradient
clip, Adam and the scheduler)."""


def read(rec):
    stages = rec.get("stage_kernel_s")
    if not stages or "optimizer" not in stages or not rec.get("units"):
        return None
    return stages["optimizer"] / rec["units"] * 1e3
