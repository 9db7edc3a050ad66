"""query_pts_per_s (points/s, host clock): the query points answered in the
window over the window's time."""


def read(run):
    if not run.window_s:
        return None
    return run.record["points"] / run.window_s
