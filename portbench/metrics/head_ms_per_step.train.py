"""Device ms a step of what the head launched: kernels launched in the
program's ``model.head`` span outside ``step.backward`` (the unembedding and
the float32 loss's forward); with their count a step (``launches``) and the
span's host ms a step (``host_ms``). From the window's phase split
(``phases.py``); None where it has none."""

PHASE = "head"


def read(w):
    phases = getattr(w, "phases", None)
    return phases.read(PHASE) if phases is not None else None
