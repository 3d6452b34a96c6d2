"""Calls that synchronize the host with the card a frame
(``torch.cuda.set_sync_debug_mode("warn")`` over the counted frames)."""


def read(rec):
    if not rec.get("sync_units") or rec.get("syncs") is None:
        return None
    return rec["syncs"] / rec["sync_units"]
