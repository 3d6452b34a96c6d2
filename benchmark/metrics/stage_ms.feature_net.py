"""Device ms a frame of the kernels launched in the FPN stage (between the
frame's start and the ``feature_net`` mark)."""


def read(rec):
    stages = rec.get("stage_kernel_s")
    if not stages or "feature_net" not in stages or not rec.get("units"):
        return None
    return stages["feature_net"] / rec["units"] * 1e3
