#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Each kernel is held against its plain version and its launches are
counted on the main paths. The phases live in ``chipsmoke/``, each with
its gates in its docstring; they run in this order and print JSON lines:

device                 the card, capability >= 9.0, TF32 off
build, ptxas           nvcc builds every source; registers and spills
launch_floor           one 8-element add, the floor under small kernels
group_mean             kernels.phase_group_mean, the [G, M, D] entry
group_mean_round       kernels.phase_group_mean_round, the main path's
flash_attention        kernels.phase_flash, rows 1-2p
paged_decode           kernels.phase_paged
decode_attention       kernels.phase_decode
ssd_scan               kernels.phase_ssd_scan
ssd_scan_grad          kernels.phase_ssd_scan_grad
ssd_scan_bwd           kernels.phase_ssd_scan_bwd
mar_rounds             kernels.phase_mar_rounds
vision                 federation.phase_vision
federation             federation.phase_federation
federation_extensions  federation.phase_federation_extensions
figures                federation.phase_figures
federation_large_n     federation.phase_federation_large_n
federation_socket      federation.phase_federation_socket
profile                federation.phase_profile
serve                  serve.phase_serve
serve_parity           serve.phase_serve_parity
serve_recurrent        serve.phase_serve_recurrent
recurrent_parity       serve.phase_recurrent_parity
serve_moe              serve.phase_serve_moe
serve_moe_parity       serve.phase_serve_moe_parity
checkpoint             serve.phase_checkpoint
train                  train.phase_train
train_recurrent        train.phase_train_recurrent
train_zamba2           train.phase_train_zamba2
train_parity           train.phase_train_parity
train_recurrent_parity train.phase_train_recurrent_parity
train_mesh             train.phase_train_mesh
kernels                one entry a kernel: its launches summed over the
                       main paths, its phase's main-path row

Then the card's nvidia-smi line and, last, ``{"ok": true, "device":
...}``. Any failed check exits non-zero before the last line; so does a
host without CUDA, or a directory without the repo's ``src/``.
"""
from __future__ import annotations

import json
import sys
import time

from chipsmoke import common, federation, kernels, serve, train
from chipsmoke.common import ROOT, check, emit, fail


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
        from repro_torch.kernels import group_mean as gm
        from repro_torch.kernels import ref
    except ImportError as e:
        fail(f"cannot import repro_torch from {ROOT / 'src'}: {e}")

    smi = common.smi_line()
    cap = torch.cuda.get_device_capability(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         capability=list(cap), torch=torch.__version__,
         cuda=torch.version.cuda, tf32_matmul=False, tf32_cudnn=False)
    check(cap >= (9, 0), f"capability {cap} < (9, 0): the kernels are "
                         f"built for sm_90a")

    t0 = time.perf_counter()
    report = _build.build_all(force=True)
    emit("build", seconds=time.perf_counter() - t0,
         sources=_build.sources(),
         ptxas={k: [ln for ln in v["log"].splitlines() if "ptxas" in ln]
                for k, v in report.items()})
    ptxas = common.ptxas_summary(report, _build.sources())
    emit("ptxas", kernels=ptxas)

    flush = torch.empty(common.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device="cuda")
    # what the timing method reads for one near-empty kernel: the floor
    # under every small kernel's time below
    tiny = torch.zeros(8, device="cuda")
    emit("launch_floor", what="one 8-element add, as device_ms times it",
         ms=common.device_ms(torch, lambda: tiny.add_(1), flush=flush))
    kernels.phase_group_mean(torch, gm, ref, flush)
    # each kernel's main-path row, and each main path's launches
    rows = {"group_mean": kernels.phase_group_mean_round(torch, flush)}
    rows["flash_attention"] = kernels.phase_flash(torch, flush)
    rows["paged_decode_attention"] = kernels.phase_paged(torch, flush)
    rows["decode_attention"] = kernels.phase_decode(torch, flush)
    rows["ssd_scan"] = kernels.phase_ssd_scan(torch, flush)
    kernels.phase_ssd_scan_grad(torch, flush)
    rows["ssd_scan_bwd"] = kernels.phase_ssd_scan_bwd(torch, flush, ptxas)
    rows["mar_rounds"] = kernels.phase_mar_rounds(torch, flush)
    del flush
    federation.phase_vision(torch)
    paths = [federation.phase_federation(torch, smi)]
    paths.append(federation.phase_federation_extensions(torch, smi))
    paths.append(federation.phase_figures(torch, smi))
    paths.append(federation.phase_federation_large_n(torch, smi))
    paths.append(federation.phase_federation_socket(torch, smi))
    federation.phase_profile(torch)
    paths.append(serve.phase_serve(torch, smi))
    serve.phase_serve_parity(torch)
    paths.append(serve.phase_serve_recurrent(torch, smi))
    serve.phase_recurrent_parity(torch)
    paths.append(serve.phase_serve_moe(torch, smi))
    serve.phase_serve_moe_parity(torch)
    serve.phase_checkpoint(torch)
    train_record = {}
    paths.append(train.phase_train(torch, smi, train_record))
    paths.append(train.phase_train_recurrent(torch, smi))
    paths.append(train.phase_train_zamba2(torch, smi))
    train.phase_train_parity(torch)
    train.phase_train_recurrent_parity(torch)
    paths.append(train.phase_train_mesh(torch, smi, train_record))

    print(json.dumps({"kernels": common.kernels_line(
        common.launch_totals(paths), rows)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
