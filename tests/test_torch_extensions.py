"""The quickstart under each protocol extension on the CPU against the
reference's ledger and accuracy.

Each run (``quickstart.EXTENSIONS``: 27 peers, 20 iterations, the
group-mean kernel's plain version) must end with the reference's
``comm_bytes`` and ``sim_seconds`` exactly and its accuracy inside the
band ``chip_smoke.py`` gates the card with: the reference's accuracy at
iteration 20 over seeds 0-2 widened on each side by that spread plus
0.05 (``chipsmoke.refs.EXTENSION_REF``, from
``tools/reference_constants.py``; torch's draws run free of jax's).
"""
from pathlib import Path

import pytest
import torch

from repro_torch.core.federation import Federation
from repro_torch.quickstart import EXTENSIONS, extension_config
from test_torch_federation import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", sorted(EXTENSIONS))
def test_quickstart_extension_matches_reference(name, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    from chipsmoke.refs import EXTENSION_REF
    want_bytes, want_s, (lo, hi) = EXTENSION_REF[name]
    fed = Federation(extension_config(name, kernel_group_mean=True),
                     device="cpu")
    state = fed.init_state()
    for _ in range(20):
        state = fed.step(state)
    assert fed.comm_bytes == want_bytes
    assert fed.sim_seconds == pytest.approx(want_s, abs=1e-9)
    acc = fed.evaluate(state)
    assert lo <= acc <= hi, (acc, lo, hi)
    assert all(bool(torch.isfinite(x).all())
               for x in [state.params["fc1"]["w"], state.params["fc2"]["b"]])
    if name == "elastic":
        assert fed.cfg.n_peers == 26 and fed.plan.dims == (3, 3, 3)
