"""The render stage's share of its roofline: the IBR head's and the
compositing's FLOPs a frame, counted once (``work.render_flops``), over
the peak TF32 rate, over the device time a frame of the kernels in the
last level's ``render_{i}`` stage, in %."""


def read(rec):
    stages = rec.get("stage_kernel_s")
    w = rec.get("work", {})
    name = w.get("render_stage")
    if not stages or name not in stages or not rec.get("units"):
        return None
    t = stages[name] / rec["units"]
    if t <= 0:
        return None
    return 100.0 * w["render_flops"] / w["peaks"]["tf32_flops_per_s"] / t
