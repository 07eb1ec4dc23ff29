"""Shared fixtures. NOTE: no XLA device-count forcing here — smoke tests
run on the single real CPU device; mesh-dependent tests spawn
subprocesses that set XLA_FLAGS before importing jax.

Also provides a conftest-level fallback for ``hypothesis`` (declared as
an optional test dependency in pyproject.toml): when the real library is
absent, a deterministic mini-shim is installed into ``sys.modules`` so
the property-test modules still *collect and run* — each ``@given`` test
executes over a fixed-seed sample of its strategies instead of erroring
out at import (the importorskip-style alternative would silently drop
every non-property test in those modules too).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:
    import hypothesis  # noqa: F401
except ImportError:
    import types

    _SHIM_MAX_EXAMPLES = 10

    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def _integers(min_value, max_value):
        return _Strategy(
            lambda r: int(r.integers(min_value, max_value + 1)))

    def _floats(min_value, max_value, **_kw):
        return _Strategy(lambda r: float(r.uniform(min_value, max_value)))

    def _booleans():
        return _Strategy(lambda r: bool(r.integers(0, 2)))

    def _sampled_from(elements):
        elements = list(elements)
        return _Strategy(lambda r: elements[int(r.integers(len(elements)))])

    def _just(value):
        return _Strategy(lambda r: value)

    def _given(*strategies, **kw_strategies):
        def decorate(fn):
            # deliberately zero-arg (and no functools.wraps): the
            # drawn parameters must not look like pytest fixtures
            def wrapper():
                n = getattr(wrapper, "_shim_max_examples",
                            getattr(fn, "_shim_max_examples",
                                    _SHIM_MAX_EXAMPLES))
                rng = np.random.default_rng(0)
                for _ in range(min(n, _SHIM_MAX_EXAMPLES)):
                    pos = tuple(s.draw(rng) for s in strategies)
                    kws = {k: s.draw(rng)
                           for k, s in kw_strategies.items()}
                    fn(*pos, **kws)
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            return wrapper
        return decorate

    def _settings(**kw):
        def decorate(fn):
            fn._shim_max_examples = kw.get("max_examples",
                                           _SHIM_MAX_EXAMPLES)
            return fn
        return decorate

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.floats = _floats
    _st.booleans = _booleans
    _st.sampled_from = _sampled_from
    _st.just = _just

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.__shim__ = True
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running (dry-run scale)")
    config.addinivalue_line(
        "markers", "cuda: runs a kernel on an NVIDIA GPU; skips without one")
