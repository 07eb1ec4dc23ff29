"""Host time an iteration inside the port's label ``federation.transport``
(lifecycle tick, message plan, the sim transport's event simulation
in NumPy: ``core/transport.py``, ``runtime/network.py``)."""
UNIT = "ms/iter"
LAYER = "federation transport"
SOURCE = "program_span"
MOVES = "fed_iter_ms"
BETTER = "lower"


def read(ctx):
    s = ctx.trace.span("federation.transport")
    if s is None:
        return None
    return s.host_us / ctx.steps / 1e3
