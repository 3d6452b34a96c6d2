"""The whole frame's share of the card's peak: the model's FLOPs a frame
(FPN, 3D CNNs, IBR head; ``work.frame_flops``) times the frame rate of
the untraced window that precedes the traced slice (``rate``: frames over
its host-clock seconds), over the peak TF32 rate, in %."""


def read(rec):
    w, r = rec.get("work", {}), rec.get("rate") or {}
    if not r.get("units") or not r.get("seconds") or "frame_flops" not in w:
        return None
    rate = w["frame_flops"] * r["units"] / r["seconds"]
    return 100.0 * rate / w["peaks"]["tf32_flops_per_s"]
