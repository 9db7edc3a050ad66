"""device_idle.fit (%, device trace): the share of the traced window in
which no operation ran on the card: 1 - (the union of the device's
activity intervals) / (the window)."""


def read(run):
    tr = run.trace_data
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
