"""fit_step_ms (ms, host clock): the window's wall time over the fits it
completed times the configuration's steps per fit. The unit of work is
fixed by the configuration, so faster steps and an optimizer that needs
fewer evaluations both show."""


def read(run):
    r = run.record
    if not r.get("fits"):
        return None
    return run.window_s / (r["fits"] * r["steps_per_fit"]) * 1e3
