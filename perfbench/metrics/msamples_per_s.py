"""Pixel samples completed over the window, in millions a second: the
samples of the passes that ended inside it over the time from its start
to the end of its last whole pass (host clock, each pass ended by a
synchronise)."""


def read(run):
    if run.window.seconds <= 0:
        return None
    return run.window.samples / run.window.seconds / 1e6
