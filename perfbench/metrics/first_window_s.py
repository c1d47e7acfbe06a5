"""The set-up's first call into the cell's window: a training window's
warm-up epoch and capture, in s."""


def read(run):
    return run.spans.get('first_window')
