"""MAR-FL core: grid, topology, transport plans, aggregation, federation."""
