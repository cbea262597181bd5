"""One module a traffic kind (the ``kind`` of a mix under ``traffic/``):
``run(cell, seed, seconds, traced, device, started)`` returns the result
line's fields with the checks last. A new kind, such as serving, is a new
module here."""
