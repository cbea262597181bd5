"""Device ms a step of the layers' recompute: kernels launched in the
program's ``model.layer`` spans inside ``step.backward`` (remat "full" runs
each layer's forward again there); with their count a step (``launches``)
and those spans' host ms a step (``host_ms``). From the window's phase split
(``phases.py``); None where it has none."""

PHASE = "recompute"


def read(w):
    phases = getattr(w, "phases", None)
    return phases.read(PHASE) if phases is not None else None
