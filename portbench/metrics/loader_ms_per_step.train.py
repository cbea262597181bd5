"""Host ms a step spends in the data path: ``Loader.batch_at`` over the
provisioned EphemeralFS and the copy of the batch to the device, averaged
over the window's steps (the harness's own span around them)."""


def read(w):
    if not w.loader_s:
        return None
    return {"value": 1e3 * sum(w.loader_s) / len(w.loader_s)}
