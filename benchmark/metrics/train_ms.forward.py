"""Device ms a step of the kernels launched in the forward phase (between
the step's start and its ``forward`` mark: the model in training mode and
the loss)."""


def read(rec):
    stages = rec.get("stage_kernel_s")
    if not stages or "forward" not in stages or not rec.get("units"):
        return None
    return stages["forward"] / rec["units"] * 1e3
