"""The device's idle share of the traced window (%): one minus the
seconds in which a kernel ran over the window's length."""


def read(cell, traced):
    if traced is None or not traced.window_s:
        return None
    return 100.0 * (1.0 - traced.busy_s / traced.window_s)
