"""Host time an iteration inside ``federation.local_update``
(``Federation._local_update``: all peers' forward, backward and SGDM at
once, ``models/small.py``, ``optim/sgdm.py``)."""
UNIT = "ms/iter"
LAYER = "federation local update"
SOURCE = "program_span"
MOVES = "fed_iter_ms"
BETTER = "lower"


def read(ctx):
    s = ctx.trace.span("federation.local_update")
    if s is None:
        return None
    return s.host_us / ctx.steps / 1e3
