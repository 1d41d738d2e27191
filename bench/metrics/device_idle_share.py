"""``device_idle_share``: 1 minus the union of the device's activity
intervals over the traced window's wall time, in %."""


def read(ctx: dict):
    s = ctx["trace"]
    return None if s is None else 100.0 * s.idle_share
