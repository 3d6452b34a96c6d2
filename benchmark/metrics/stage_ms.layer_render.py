"""Device ms a frame of the kernels launched in the composite's render
stages at its last rendered level (``fg_render_{i}``, ``bg_render_{i}``:
the rays, the window crop, the raw heads, the paste; ``composite_{i}``:
the layers' compositing)."""


def read(rec):
    stages = rec.get("stage_kernel_s")
    names = rec.get("work", {}).get("layer_render_stages")
    if not stages or not names or not rec.get("units"):
        return None
    if not all(n in stages for n in names):
        return None
    return sum(stages[n] for n in names) / rec["units"] * 1e3
