"""The ``torch.profiler`` labels inside the trainer's local update
(``core/fl_device.py``, ``models/transformer.py``,
``models/attention_flash.py``), counted on a tiny LM on the CPU.

A step of ``make_fl_train_step`` opens, per peer, local step and
micro-batch, one ``train.local_update.forward`` and one
``train.local_update.backward``; per peer and local step one
``train.local_update.optimizer``; and, per block and micro-batch, one
``model.recompute`` (remat's second run of the block, in the backward)
and one ``flash_attention.backward``. The forward's run of a block
opens no ``model.recompute``, nor does a forward without remat or under
``torch.no_grad()``; and the labels change no number of the step.
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.core import fl_device
from repro_torch.core.moshpit import plan_grid
from repro_torch.models import attention_flash, transformer
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves

P, LAYERS, MB, S = 4, 2, 1, 16
SPANS = (fl_device.SPAN_FORWARD, fl_device.SPAN_BACKWARD,
         fl_device.SPAN_OPTIMIZER, transformer.SPAN_RECOMPUTE,
         attention_flash.SPAN_BACKWARD)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors on a CPU shared by several test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(remat: str) -> Model:
    return Model(dataclasses.replace(
        get_smoke_config("musicgen-medium"), num_layers=LAYERS,
        dtype="float32", remat=remat, attn_impl="flash"))


def _batch(cfg, local_steps: int, n_micro: int):
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size,
                         (P, local_steps, n_micro, MB, S), generator=gen,
                         dtype=torch.int32)
    return {"tokens": toks, "labels": torch.roll(toks, -1, -1)}


def _counts(prof):
    names = [e.name for e in prof.events()]
    return {span: names.count(span) for span in SPANS}


def _step(model, batch):
    state = fl_device.init_fl_state(model, P, seed=3, device="cpu")
    step = fl_device.make_fl_train_step(model, plan_grid(P), lr=0.1)
    return step(state, batch)


@pytest.mark.parametrize("local_steps,n_micro", [(1, 1), (2, 1), (1, 2)])
def test_local_update_spans_per_step(local_steps, n_micro):
    model = _model("block")
    batch = _batch(model.cfg, local_steps, n_micro)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, met = _step(model, batch)
    passes = P * local_steps * n_micro
    assert _counts(prof) == {
        fl_device.SPAN_FORWARD: passes,
        fl_device.SPAN_BACKWARD: passes,
        fl_device.SPAN_OPTIMIZER: P * local_steps,
        transformer.SPAN_RECOMPUTE: LAYERS * passes,
        attention_flash.SPAN_BACKWARD: LAYERS * passes}
    # the same step with the profiler off: the same bits
    want_state, want_met = _step(model, batch)
    assert torch.equal(met["loss"], want_met["loss"])
    got = tree_leaves(state["params"]) + tree_leaves(state["momentum"])
    want = (tree_leaves(want_state["params"])
            + tree_leaves(want_state["momentum"]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["remat_none", "no_grad"])
def test_no_recompute_span_without_a_recompute(mode):
    model = _model("none" if mode == "remat_none" else "block")
    batch = _batch(model.cfg, 1, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if mode == "remat_none":
            _step(model, batch)
        else:
            params = model.init(0, device="cpu")
            mb = {k: v[0, 0, 0] for k, v in batch.items()}
            with torch.no_grad():
                model.loss(params, mb)
    counts = _counts(prof)
    assert counts[transformer.SPAN_RECOMPUTE] == 0
    if mode == "remat_none":
        assert counts[fl_device.SPAN_FORWARD] == P
        assert counts[attention_flash.SPAN_BACKWARD] == LAYERS * P
    else:
        assert not any(counts.values())
