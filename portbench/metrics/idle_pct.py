"""The share of the traced window in which no device operation runs:
100 * (1 - the union of their intervals / the window). Its names with a
suffix (idle_pct.adam, idle_pct.p512, ...) read the same in their cells."""


def read(rec):
    if rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
