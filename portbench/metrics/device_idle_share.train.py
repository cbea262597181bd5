"""The share of the traced window in which no device activity ran (the
union of the profiler's kernel and copy intervals against the window)."""


def read(w):
    if w.window_s <= 0 or not w.events:
        return None
    return {"value": 100.0 * max(0.0, 1.0 - w.busy_s / w.window_s)}
