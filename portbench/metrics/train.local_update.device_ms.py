"""Device time a step of the work launched under the port's label
``train.local_update`` (every peer's forward, backward and SGDM:
``core/fl_device.peer_local_update``, ``models/model.py``,
``optim/sgdm.py``), matched by correlation id."""
UNIT = "ms/step"
LAYER = "trainer local update"
SOURCE = "device_trace"
MOVES = "train_step_ms"
BETTER = "lower"


def read(ctx):
    s = ctx.trace.span("train.local_update")
    if s is None or s.device_us <= 0:
        return None
    return s.device_us / ctx.steps / 1e3
