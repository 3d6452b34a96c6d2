"""The composite's render stages' share of their roofline: the least time
of the heads' and the compositing's work a frame, the larger of their
FLOPs (``work_composite.layer_render_flops``) over the peak TF32 rate and
their bytes (``layer_render_bytes``) over the HBM's peak bytes/s, over
the device time a frame of the kernels in the stages that
``stage_ms.layer_render`` reads, in %."""


def read(rec):
    stages = rec.get("stage_kernel_s")
    w = rec.get("work", {})
    names = w.get("layer_render_stages")
    if not stages or not names or not rec.get("units") or "layer_render_flops" not in w:
        return None
    if not all(n in stages for n in names):
        return None
    t = sum(stages[n] for n in names) / rec["units"]
    if t <= 0:
        return None
    p = w["peaks"]
    bound = max(w["layer_render_flops"] / p["tf32_flops_per_s"],
                w["layer_render_bytes"] / p["hbm_bytes_per_s"])
    return 100.0 * bound / t
