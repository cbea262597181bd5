"""One module a kernel of the port, found by its name: ``TAP`` (the entry
of the program whose calls launch it), ``PATTERN`` (its device kernels'
names) and ``work(*args, **kwargs)`` (bytes and operations of one call)."""
