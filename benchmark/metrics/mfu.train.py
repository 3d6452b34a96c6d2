"""The whole train step's share of the card's peak: the step's FLOPs
(forward and backward, ``work.step_flops``) times the step rate of the
untraced window that precedes the traced slice (``rate``: steps over its
host-clock seconds), over the peak TF32 rate, in %."""


def read(rec):
    w, r = rec.get("work", {}), rec.get("rate") or {}
    if not r.get("units") or not r.get("seconds") or "step_flops" not in w:
        return None
    rate = w["step_flops"] * r["units"] / r["seconds"]
    return 100.0 * rate / w["peaks"]["tf32_flops_per_s"]
