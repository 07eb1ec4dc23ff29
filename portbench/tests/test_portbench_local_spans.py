"""The trace reader (``portbench/trace.py``) on hand-made events laid out
as the trainer's local update records them: the window's thread opens
``train.local_update`` and, inside it, ``.forward``, ``.backward`` and
``.optimizer``; the autograd engine's thread, while the window's thread
waits in the backward, opens ``model.recompute`` and
``flash_attention.backward`` and issues their launches."""
from types import SimpleNamespace

import pytest
import torch

from portbench import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MAIN, AUTOGRAD = 1, 2
LOCAL = "train.local_update"
INNER = ("train.local_update.forward", "train.local_update.backward",
         "train.local_update.optimizer", "model.recompute",
         "flash_attention.backward")


def _ev(name, start, end, dev=CPU, id=0, thread=MAIN):
    return SimpleNamespace(name=name, device_type=dev, id=id, thread=thread,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=dev == CPU and "." in name)


def _events():
    return [
        _ev(trace.WINDOW, 0, 200),
        _ev(LOCAL, 0, 100),
        _ev("train.local_update.forward", 0, 30),
        _ev("cudaLaunchKernel", 10, 11, id=1),
        _ev("train.local_update.backward", 30, 80),
        _ev("model.recompute", 32, 45, thread=AUTOGRAD),
        _ev("cudaLaunchKernel", 35, 36, id=2, thread=AUTOGRAD),
        _ev("flash_attention.backward", 50, 60, thread=AUTOGRAD),
        _ev("cudaLaunchKernel", 55, 56, id=3, thread=AUTOGRAD),
        _ev("cudaLaunchKernel", 65, 66, id=4, thread=AUTOGRAD),
        _ev("train.local_update.optimizer", 80, 98),
        _ev("cudaLaunchKernel", 82, 83, id=5),
        _ev("cudaLaunchKernel", 90, 91, id=6),
        _ev("train.aggregate", 100, 200),
        _ev("cudaLaunchKernel", 110, 111, id=7),
        _ev("fwd_gemm", 12, 20, CUDA, id=1),
        _ev("rms_norm", 36, 40, CUDA, id=2),
        _ev("bwd_einsum", 56, 62, CUDA, id=3),
        _ev("grad_sum", 67, 70, CUDA, id=4),
        _ev("sgdm_mul", 84, 88, CUDA, id=5),
        _ev("sgdm_copy", 91, 95, CUDA, id=6),
        _ev("mean_kernel", 112, 190, CUDA, id=7),
        _ev("model.recompute", 36, 40, CUDA),        # the label's GPU range
    ]


def test_inner_spans_partition_the_local_update():
    s = trace.summarize(_events(), (LOCAL, "train.aggregate") + INNER)
    got = {lab: (s.span(lab).host_us, s.span(lab).count,
                 s.span(lab).launches, s.span(lab).device_us)
           for lab in INNER}
    assert got == {"train.local_update.forward": (30, 1, 1, 8),
                   "train.local_update.backward": (50, 1, 3, 13),
                   "train.local_update.optimizer": (18, 1, 2, 8),
                   "model.recompute": (13, 1, 1, 4),
                   "flash_attention.backward": (10, 1, 1, 6)}
    lu = s.span(LOCAL)
    assert (lu.launches, lu.device_us) == (6, 29)
    phases = INNER[:3]
    assert sum(s.span(p).device_us for p in phases) == lu.device_us
    assert sum(s.span(p).launches for p in phases) == lu.launches
    # the GPU copy of a label is not device work
    assert s.busy_us == 8 + 4 + 6 + 3 + 4 + 4 + 78
    idle = dict(s.idle_gaps)
    # gaps are named by the window's thread: the backward's read python
    assert idle["train.local_update.forward/python"] == pytest.approx(
        (12 + (36 - 20)) / 1e6)
    assert idle["train.local_update.backward/python"] == pytest.approx(
        ((56 - 40) + (67 - 62) + (84 - 70)) / 1e6)
    assert idle["train.local_update.optimizer/python"] == pytest.approx(
        (91 - 88) / 1e6)


def test_inner_spans_with_the_two_halves_labels_alone():
    """Read with ``entries/fl_train.LABELS`` as it stands: no inner span
    is reported, the halves read as before, and a gap takes the inner
    span open on the window's thread as its host operation."""
    s = trace.summarize(_events(), (LOCAL, "train.aggregate"))
    assert all(s.span(lab) is None for lab in INNER)
    lu = s.span(LOCAL)
    assert (lu.launches, lu.device_us) == (6, 29)
    idle = dict(s.idle_gaps)
    assert idle[f"{LOCAL}/train.local_update.backward"] == pytest.approx(
        35e-6)
    assert f"{LOCAL}/python" not in idle
