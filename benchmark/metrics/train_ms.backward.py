"""Device ms a step of the kernels launched in the backward phase (between
the step's ``forward`` and ``backward`` marks: the autograd engine's
kernels)."""


def read(rec):
    stages = rec.get("stage_kernel_s")
    if not stages or "backward" not in stages or not rec.get("units"):
        return None
    return stages["backward"] / rec["units"] * 1e3
