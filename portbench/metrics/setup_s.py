"""setup_s (s, host clock): from the start of the run's process to the
start of the measured window: imports, the card's start-up, the data, the
kernel library (built on a checkout's first run), the serve state, and the
warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
