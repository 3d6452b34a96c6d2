"""The device's idle share over the steady part of the traced steps (from
the end of the second step): 1 − busy / span, in %."""


def read(rec):
    share = rec.get("steady_idle_share")
    return None if share is None else 100.0 * share
