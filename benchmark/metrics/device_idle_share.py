"""The card's idle share of the traced window, in percent: 1 - the union
of every device operation's interval over the window."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
