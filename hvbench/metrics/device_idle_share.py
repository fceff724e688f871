"""The share of the profiled window, in %, in which no operation ran on
the device: 100 * (1 - busy / wall)."""


def read(t):
    p = t.profile
    if p is None or p.wall_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.wall_s)
