"""Device ms a step of the gradients: kernels launched in the program's
``step.backward`` span outside ``model.layer`` (every gradient kernel, the
loss's and the unembedding's included); with their count a step
(``launches``) and that part of the span's host ms a step (``host_ms``).
From the window's phase split (``phases.py``); None where it has none."""

PHASE = "backward"


def read(w):
    phases = getattr(w, "phases", None)
    return phases.read(PHASE) if phases is not None else None
