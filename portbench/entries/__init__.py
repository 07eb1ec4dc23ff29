"""Entries: one module per path of the port that cells drive, loaded by
the name a cell's file gives (``spec.Bench.entry``)."""
