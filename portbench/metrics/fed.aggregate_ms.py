"""Host time an iteration inside ``federation.aggregate``
(``core/aggregation.py`` -> ``mar_allreduce._kernel_round``: one
group-mean launch a MAR round, and the ledger)."""
UNIT = "ms/iter"
LAYER = "federation aggregation"
SOURCE = "program_span"
MOVES = "fed_iter_ms"
BETTER = "lower"


def read(ctx):
    s = ctx.trace.span("federation.aggregate")
    if s is None:
        return None
    return s.host_us / ctx.steps / 1e3
