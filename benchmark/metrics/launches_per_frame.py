"""Device launches (kernels, copies and fills) a frame in the traced slice,
from the profiler's device records: the host-dispatch layer's count."""


def read(rec):
    if not rec.get("units") or rec.get("launches") is None:
        return None
    return rec["launches"] / rec["units"]
