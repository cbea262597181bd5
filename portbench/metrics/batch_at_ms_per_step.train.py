"""Host ms a step in the program's ``data.batch_at`` span (``Loader.batch_at``
reading the staged shards through the FS client), with the bytes it read
over that time (``read_mb_per_s``). From the window's phase split
(``phases.py``); None where it has none. ``loader_ms_per_step.train`` times
the same layer from the harness, with the copy to the device."""


def read(w):
    phases = getattr(w, "phases", None)
    return phases.read_batch_at() if phases is not None else None
