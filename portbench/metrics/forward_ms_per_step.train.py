"""Device ms a step of what the forward launched: kernels launched in the
program's ``step.forward`` span outside ``model.head`` (the embedding, the
layers, the final norm); with their count a step (``launches``) and the
host ms a step in that part of the span (``host_ms``). From the window's
phase split (``phases.py``); None where it has none."""

PHASE = "forward"


def read(w):
    phases = getattr(w, "phases", None)
    return phases.read(PHASE) if phases is not None else None
