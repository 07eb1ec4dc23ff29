#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device     — the card (nvidia-smi name and power limit, capability
                >= 9.0, torch and CUDA versions); TF32 is switched off
                for matmuls and cuDNN so f32 means f32.
2. build      — nvcc builds every kernel under
                src/repro_torch/kernels/csrc/, one process per source,
                all started together, the libraries already built too
                (so the report is whole); a ``ptxas`` line gives the
                registers, spill bytes and static shared memory of each
                group-mean, flash, decode, SSD-scan and MAR-rounds
                kernel.
3. group_mean — a launch_floor line first: one 8-element add timed as
                every row below is, the floor under every small
                kernel's time. Then the [G, M, D] entry against its
                plain PyTorch version on the card, at the old
                per-leaf shapes (G=9, M=3, D in {98304, 128, 2560, 20},
                f32), D=98304 in bf16, a ragged tail (D=1000) and D=1,
                each with a fully dropped group; f32 within 2e-5, bf16
                within 2e-2; median times of 20 CUDA-event-timed calls,
                L2 flushed before each, beside the memory bound.
   group_mean_round — the round kernel, the main path's entry, through
                ``_kernel_round`` against the round's plain version: the
                quickstart's theta and momentum (N=27 on 3x3x3) in each
                of the 3 rounds, N=26 on the same grid (virtual slots),
                the same tree in bf16, and a tree of more than
                MAX_LEAVES leaves mixing f32 and bf16 (odd widths, d=1,
                offset views), each mask dropping one whole group. f32
                within 2e-5 and bf16 within 2e-2, every leaf bit-equal
                to the route the kernel replaced (gather by order, the
                [G, M, D] entry, gather back), the dropped group kept
                bit for bit, one launch per dtype batch. Times with L2
                flushed: the kernel, that route, the plain version and
                the kernel-off route (grouped sums), beside the bound, and
                the host time of a round.
4. flash_attention, paged_decode, decode_attention — each attention
                kernel against its plain version on the card, at the
                serving path's shapes in bf16 and f32 plus ragged cases
                and the bf16 kernels' tile edges (flash: s=512, 24 and
                1000, s=65 and 129 one past a 64-row tile, d=80 at
                s=200, o and lse; paged: lengths 1, full and mid-page
                and a row on the scratch page only; dense decode:
                S=1000, S=1, and rows of length 0, which must be
                zeros). f32 within 2e-5, bf16 within 2e-2: the kernels
                sum in another order than the plain versions, the bf16
                kernels round the probabilities to bf16 before P V, and
                the plain decode paths round them to v's dtype. Median
                device times of the kernel, the plain version and one
                PyTorch library call (SDPA) beside the bound, with L2
                flushed before each; every row also gives bound_share
                (bound / kernel time) and vs_library (kernel / library
                time, null without a library call). The launch_floor
                (phase 3) is the floor under every small kernel's time.
5. vision     — 16 peers on the vision task (the CNN), 3 iterations,
                kernel on: finite loss, disagreement <= 1e-10, 12
                kernel launches (3 iterations x 4 rounds x 1 batch).
6. federation — the quickstart config (27 peers, text task, MLP head
                768->128->20, kernel on) for 20 iterations on the card:
                accuracy >= 0.30, peer disagreement <= 1e-10, the ledger
                exactly as the reference's (2,618,231,040 bytes,
                0.89577216 simulated seconds), 60 kernel launches (one
                per round: 20 x 3 rounds x 1 f32 batch); then
                the same run with the kernel off must end within 1e-5.
   federation_extensions — the same quickstart under each protocol
                extension (``quickstart.EXTENSIONS``), kernel on, 20
                iterations: Moshpit-KD (kd_iterations 6), DP at sigma
                0.3, DP with the clipping indicator securely aggregated,
                int8 error feedback, staleness-1 async, all of them
                composed, and elastic membership (27 -> 13 peers at
                iteration 7, -> 26 at 14, iid churn at 0.9
                participation and 0.1 dropout). Each run's ledger
                exactly the reference's (EXTENSION_REF, from
                tools/reference_constants.py), one group-mean launch
                per MAR round (60 a run, 67 for the elastic one: depths
                3, 4 and 3), finite params, accuracy at iteration 20
                inside the band the CPU tests state, the DP clip moved,
                int8's bytes a quarter of the quickstart's, the elastic
                run's fleet 27 -> 13 -> 26 with its survivors bit-exact
                across each change and its joiners within 1e-6 of the
                f32 mean; a kernel-off rerun of each, within 1e-5 for
                async and elastic and printed for the others (a
                quantization, a teacher ranking or DP's clipping
                indicator can turn a 1e-7 difference into a step); and
                one more run of each in which every aggregation is also
                computed by the kernel-off route from the same input,
                within 1e-5 of the kernel's. Each row gives
                first_step_ms, ms_per_iteration and the card.
   figures    — ``repro_torch.figures --smoke`` (Figs. 1-5, 8 and 11, 8
                peers, 6 iterations) on the card, the group mean in the
                kernel: every row's comm_mb and sim_s equal the
                reference's (FIGURE_ROWS), Fig. 5's divergence from
                FedAvg within 1e-5, Fig. 8's partition statistics and
                Fig. 11's comm_mb equal and their accuracy in the band
                (FIGURE_EXT_ROWS), the kernel launched, each run's ms per
                iteration.
                Then Fig. 5's MAR (kernel on and off) and FedAvg
                configs at N=125, two runs of 10 steps each: every
                route is exact from run to run.
   federation_large_n — the large-N engines and controllers
                (LARGE_N_RUNS, kernel on, 20 iterations): the text model
                at N=125 under tail-aware adaptive group sizing on the
                wireless profile, once under each transport (sim,
                vector_sim, super_sim), and clustered placement at N=64
                on shuffled regions (vector_sim). Each run's ledger by
                source, sim_seconds (1e-9), regroup_log and
                placement_log exactly the reference's (LARGE_N_REF, from
                tools/reference_constants.py), the transports' ledgers
                equal, two regroups (5x5x5 -> 3^5 over 243 slots -> 2^7
                over 128), one group-mean launch per round of the grid in
                force at each step, accuracy at 20 in the reference's
                band, and every aggregation of a second run within 1e-5
                of the kernel-off route on the same input; ms per
                iteration per transport.
   federation_socket — the real TCP transport: the quickstart (kernel
                on) over ``transport="socket"`` in loopback mode, 20
                iterations, its theta and m bit-equal to the sim route's
                after every iteration, the reference's 2,618,231,040
                bytes, 60 launches, accuracy >= 0.30, the frames'
                payload bytes the billed bytes and the payload blobs
                encoded on the card byte-equal to the CPU's, ms per
                iteration beside the sim route's; the same under
                injected loss (SOCKET_LOSSY: each iteration's lost
                senders, the ledger and the accuracy band of SOCKET_REF);
                two spawned ranks of a loopback address book over the
                quickstart's mar, ar and fedavg plans, byte-exact
                against the sim, and ``python -m
                repro_torch.transport_calibration --smoke``; the
                starcoder2-3b smoke trainer over socket in process and
                as two rank processes (``--peer-hosts``, ``--rank``), each
                comm-total line the reference's (TRAIN_CLI_COMM,
                TRAIN_CLI_RANKS, wall-clock seconds masked).
7. profile    — ten quickstart steps under ``torch.profiler``: host and
                device time of each layer ``Federation.step`` labels
                (transport, local update, aggregation), the
                aggregation's kernel launches, the device's launches per
                step and busy share, the kernels that fill it; then the
                same for the DP+secagg and MKD configs, the latter with
                the MKD rounds' own label (three of its ten profiled
                steps distill).
8. serve      — the published starcoder2-3b (30 layers, d 3072, bf16,
                flash attention, random weights from seed 0) at full
                width through the continuous-batching engine: 16
                sessions, prompts drawn as --vary-prompts draws them,
                batch 8, pages of 16, pad_len 512, 64 new tokens each.
                Every session finishes with 64 tokens, the pool is
                quiescent, the logits are finite, and the flash and
                paged kernels launch 30 times per prefill and per decode
                step. Then ten decode steps and one prefill under
                ``torch.profiler``.
9. serve_parity — the same widths at 2 layers in f32: the engine's
                greedy streams (paged kernel) equal the sequential
                baseline's (plain dense decode), and prefill logits with
                the flash kernel agree with the plain path within 1e-4.
10. serve_recurrent — the published zamba2-2.7b (54 layers: 45 Mamba2
                and 9 applications of one shared attention block, d 2560)
                and xlstm-350m (24 layers: 21 mLSTM and 3 sLSTM, d 1024)
                at full width, bf16, random weights from seed 0, through
                run_sequential (their serving path): 4 sessions, prompts
                of exactly 512 tokens, 32 new tokens each. Every session
                ends with its tokens, the logits are finite, and each
                prefill launches exactly 45 SSD-scan + 9 flash kernels
                (zamba2) or 21 SSD-scan kernels (xlstm).
11. recurrent_parity — both families' widths at reduced depth in f32:
                kernel-path prefill logits within 1e-4 of the plain
                path's, and equal greedy streams (a parting at a near
                tie is printed with its top-2 logits).
12. serve_moe — the published moonshot-v1-16b-a3b (48 layers, d 2048,
                16 heads of 128 with kv 16, 64 experts top-6 of d_ff
                1408 and 2 shared, vocab 163,840, bf16; 28,888,467,456
                parameters drawn on the card from seed 0, after the
                earlier phases freed their models) through the engine
                with the serve phase's traffic: every session ends with
                64 tokens, the pool is quiescent, the logits and aux
                are finite, flash launches 48 times per prefill and the
                paged kernel 48 times per decode step. Prints the
                parameter count and bytes, the peak device memory,
                tokens/s, TTFT and per-token times; then ten decode
                steps and one prefill under ``torch.profiler``, the MoE
                expert products and combine (label ``moe``) apart.
13. serve_moe_parity — moonshot's widths at 2 layers in f32: the
                engine's greedy streams equal the sequential baseline's
                and a second engine run's (the combine is
                deterministic), and the flash kernel's prefill logits
                are within 1e-4 of the plain path's.
14. checkpoint — moonshot's smoke config on the card: an FL state
                (params and momentum, a peer axis of 3, bf16 and the
                f32 router) saved and restored bit for bit with and
                without ``like`` (the default device, CUDA); an engine
                polling the directory every 2 steps swaps a newer step
                in mid-drain (``ckpt:2``) with no session dropped, its
                weights bit for bit the peer mean
                ``serving_params_from_checkpoint`` makes on the CPU.
15. train     — the published musicgen-medium (48 layers, d 1536, 24
                MHA heads of 64, gated FFN 6144, vocab 2048, bf16;
                1,818,379,776 parameters a peer, drawn on the card from
                seed 0) trained at full width through
                ``repro_torch.launch.train.main``: 4 peers on the (2, 2)
                grid, batch 2 of 128 tokens a peer, one local step, 6
                steps, the state updated in place. Prints every step's
                loss and ms, the median ms of steps 2-6, tokens/s and
                the peak memory; then one more step under
                ``torch.profiler`` (busy share, launches, host and
                device ms under ``train.local_update`` and
                ``train.aggregate``). Gates: finite losses, every peer's
                theta and m bit-equal after each step, flash launched
                48 layers x 4 peers x 2 (forward and the remat
                recompute) a step, mar_rounds 26 a step (one a leaf), the ledger the reference's
                (TRAIN_COMM_BYTES), the peak under the card's memory.
16. train_parity — starcoder2-3b's and musicgen-medium's smoke configs
                (prefix embeddings) at 2 layers in f32: 3 steps of
                ``make_fl_train_step`` from one theta^0 on the card and
                on the CPU, full participation and U != A with int8 EF
                over a bf16 wire: losses within 1e-4, theta within 1e-4
                (int8: rare one-quantum flips); a ``--resize-at`` CLI
                run on the card with its survivors bit-exact and the
                reference's comm line.
   train_recurrent — zamba2-2.7b (2,063,209,520 parameters) and
                xlstm-350m (518,640,640) at full width, bf16, seed 0,
                through ``launch.train.main`` with the train phase's
                traffic (4 peers on (2, 2), batch 2 of 128, 6 steps): the
                SSD-scan kernel forward in every Mamba2 / mLSTM layer and
                again in its remat recompute, its backward the backward
                kernel for zamba2's Mamba2 (dk = dv = 64) and the plain
                chunked scan's VJP for xlstm's mLSTM (``_SsdScanFn``);
                the train phase's gates, with 360 SSD-scan, 360
                backward-kernel (180 calls) and 36 flash launches a
                zamba2 step (the shared attention block is not
                rematerialized) and 168 SSD-scan and no backward-kernel
                launches an xlstm step, 38 and 32
                mar_rounds launches a step (one a leaf), and the ledgers
                of TRAIN_RECURRENT.
   train_zamba2 — the published Zamba2-2.7B (``models/zamba2.py``,
                2,662,214,560 parameters) at the shape of the cell
                ``zamba2-2.7b.fl_train_4k``: 2 peers on (2,), one local
                step of 1 x 4,096 tokens, 3 steps, bf16, seed 0, through
                ``make_fl_train_step``: finite losses, the peers bit-equal
                after each step, 36 flash (d = 160), 216 SSD-scan and 44
                mar_rounds launches a step, counted from 0 just before
                the first, the peak under the card's memory.
   train_recurrent_parity — both families' smoke configs at 2 layers in
                f32: 3 steps on the card and on the CPU from one
                theta^0, losses and theta within 1e-4, 96 SSD-scan
                launches on the card.
   train_mesh — the multi-rank device backend. (a) musicgen-medium at
                full width with the train phase's traffic (4 peers on
                (2, 2), batch 2 of 128, seed 0) for TRAIN_MESH_STEPS
                steps through ``make_fl_train_step`` on a state laid out
                as DTensors by the sharding rules on a one-rank NCCL
                ``DeviceMesh`` (data=1, model=1): after each step theta
                and m equal the train phase's bit for bit (per-leaf,
                per-peer digests: the sums of the bit patterns and of
                their squares, mod 2^64, recorded by the train phase's
                ``on_step``), finite losses, 384 flash launches a step,
                26 mar_rounds launches a step (both rounds lie inside
                the rank, so a leaf takes them in one launch),
                the reference's ledger for 3 steps, the peak under
                80 GB; ms a step beside the train phase's. (b) two
                processes on the one card, meeting over gloo (NCCL
                refuses two ranks on one card): musicgen's smoke config
                in f32, 2 peers a rank on (2, 2), so round 0 crosses
                ranks and round 1 is local; theta and m within 1e-6 of
                the unsharded step on the same inputs, round 0 one
                all_reduce over 2 ranks, round 1 none, ``one_shot`` one
                over 2. Two processes on one card, not a multi-card
                result. (c) the roofline line of (a)'s step:
                ``runtime/op_analysis.py`` over one more, untimed step,
                the H100 datasheet terms (``runtime/roofline.py``)
                beside the measured ms.
17. kernels   — one JSON object per kernel: launches on its main path
                (the group mean's: the federation run's 60, the
                extension runs' 427, the smoke figures', the large-N
                runs' and the socket runs' 120; flash's and the paged
                kernel's include the moonshot run's, flash's the
                training runs' (train_mesh's too) and the in-process
                socket trainer's,
                the SSD scan's the recurrent training runs' (the
                published Zamba2's too), the MAR
                rounds kernel's the training runs' and the in-process
                socket trainer's), max error, times, bound.

Phase 4 also runs the flash kernel at zamba2's shared-attention shape
(s=512, h=kvh=32, d=80, bf16), flash and the paged kernel at
moonshot's (h=kvh=16, d=128: one query head per kv head, g=1) in bf16
and f32, flash at the trainers' shapes (row 2t, musicgen-medium: b=2,
s=128, h=kvh=24, d=64; row 2h, zamba2's shared block: h=kvh=32, d=80;
row 2p, the published Zamba2's: b=1, s=4,096, h=kvh=32, d=160 scaled by
(160 / 2) ** -0.5, the template's d = 160 instance; bf16) with the plain
backward's time beside SDPA's backward (not gated), and an ``ssd_scan``
phase holds the
SSD-scan kernel against its plain sequential version at both families'
prefill shapes (zamba2: 80 heads, dk=dv=64, B and C broadcast with a
head stride of 0, Mamba's decay rates; xlstm: 4 heads, dk 512, dv 513),
at the published Zamba2's training shape (b=1, S=4,096, bf16, timed),
S=200 and S=1 with a nonzero h0, in f32 and bf16, and in bf16 one past
a 64-step chunk (zamba2, S=65 and 129) and with v at an odd time stride
(zamba2) or cut to dv 512 (xlstm), so every instantiation of the bf16
kernel runs, within 1e-4 and 2e-2 relative to the largest |y| and |h|,
with median times of the path rows (both types) beside the bound. An
``ssd_scan_grad`` phase then holds the scan's autograd Function (the
kernel forward; the backward kernel for zamba2's bf16 calls, the plain
VJP for xlstm's and f32's) against autograd of the plain
sequential scan at the trainer's two shapes (b=2, S=128), in bf16 and
f32, with a nonzero h0 and both cotangents, and prints the forward
kernel's time beside the plain backward's. An ``ssd_scan_bwd`` phase
holds the backward kernel against the plain VJP at the published
Zamba2's call (b=1, S=4,096, 80 heads, bf16, B and C at head stride 0):
dq, dk and dv within 8e-3 of each head's peak, dlog_a within 2e-3 of
its peak, no spills, its time beside its bound (67.9 us, FLOPs at the
forward's 256-step chunks, as ``ssd_scan_bwd_roofline`` counts them) and
the plain VJP's. A ``mar_rounds`` phase holds
the device aggregation's kernel against its plain version at the train
phase's state (musicgen-medium's theta and m, 4 peers on (2, 2), 43.6
GB on the card), leaf by leaf under a full mask and one that empties a
group, bit for bit, and times the whole state's aggregation with the
kernel and with the plain route, L2 flushed, beside the bytes bound.

Then the card's nvidia-smi line and, last, ``{"ok": true, "device":
...}``. Any failed check exits non-zero before the last line; so does a
host without CUDA, or a directory without the repo's ``src/``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
L2_FLUSH_BYTES = 256 << 20     # written before a timed call: > 50 MB L2
QUICKSTART_BYTES = 2_618_231_040
QUICKSTART_SIM_S = 0.89577216
# The quickstart under each protocol extension (quickstart.EXTENSIONS),
# 20 iterations: the reference's comm_bytes and sim_seconds at seed 0,
# and the accuracy band at iteration 20, the reference's accuracy over
# seeds 0-2 widened on each side by its spread plus 0.05 (torch's draws
# are not jax's). All from the JAX package on the CPU, through
# tools/reference_constants.py.
EXTENSION_REF = {
    "mkd": (3012209856, 1.0488752639999996,
            (0.4314, 0.6076)),   # seeds 0-2: 0.5186, 0.5322, 0.5068
    "dp": (2618231040, 0.8957721599999997,
           (0.117, 0.2492)),     # seeds 0-2: 0.1885, 0.1807, 0.1777
    "dp_secagg": (2618231040, 0.8957721599999997,
                  (0.117, 0.2492)),  # seeds 0-2: 0.1885, 0.1807, 0.1777
    "int8_ef": (654557760, 0.31394303999999995,
                (0.3279, 0.5305)),   # seeds 0-2: 0.418, 0.4463, 0.4121
    "async": (2618231040, 0.8957721599999997,
              (0.159, 0.4553)),      # seeds 0-2: 0.3398, 0.334, 0.2744
    "composed": (1048536576, 0.467046144,
                 (0.0633, 0.2014)),  # seeds 0-2: 0.126, 0.1387, 0.1289
    "elastic": (1215376384, 0.8112654079999999,
                (0.2693, 0.5305)),   # seeds 0-2: 0.4268, 0.373, 0.4082
}
# The quickstart over the socket transport under injected loss (the
# federation_socket phase): the socket keeps only the loss rate of the
# link knobs and draws each peer-sourced frame's loss from (seed,
# iteration) alone
SOCKET_LOSSY = dict(transport="socket", link_params={"loss": 0.2})
# The reference's socket run of the quickstart under SOCKET_LOSSY at seed 0
# (20 iterations): each iteration's lost senders as a bit mask (bit i is
# peer i), the ledger by source, and the accuracy band at iteration 20
# (seeds 0-2 widened by their spread plus 0.05, as EXTENSION_REF); from
# the JAX package on the CPU through tools/reference_constants.py
SOCKET_REF = dict(
    lost_senders=[82247135, 99270654, 56612351, 132119550, 133922796,
                  96320281, 131583615, 116744053, 133431119, 29222197,
                  134208983, 50261903, 117372821, 66402303, 115862508,
                  111081439, 117063679, 49585849, 115105407, 134176158],
    by_source={"agg/mar": 2618231040.0},
    band=(0.2459, 0.4865),   # seeds 0-2: 0.3896, 0.376, 0.3428
)
# repro_torch.figures --smoke: each row's comm_mb and sim_s as the
# reference's figure scripts print them at that scale, seed 0 (None: the
# row has no such field); same source
FIGURE_ROWS = (
    ("fig1_train", "77.6", "0.09"), ("fig1_train", "116.4", "0.191"),
    ("fig1_train", "116.4", "0.152"), ("fig1_train", "116.4", "0.152"),
    ("fig1_train", "271.5", "0.356"), ("fig1_train", "271.5", "0.284"),
    ("fig2_mkd", "116.4", None), ("fig2_mkd", "174.7", None),
    ("fig2_mkd", "174.7", None),
    ("fig3_churn", "46.9", None), ("fig3_churn", "72.7", None),
    ("fig3_churn", "56.6", None), ("fig3_churn", "72.7", None),
    ("fig3_churn", "59.8", None),
    ("fig4_dp", "116.4", None), ("fig4_dp", "116.4", None),
    ("fig4_dp", "116.4", None), ("fig4_dp", "116.4", None),
    ("fig5_parity", None, None), ("fig5_parity", None, None),
    ("fig5_parity", None, None), ("fig5_parity", None, None),
    ("fig5_divergence", None, None), ("fig5_divergence", None, None),
    ("fig5_divergence", None, None),
)
# repro_torch.figures --smoke, Figs. 8 and 11: each row as the reference's
# scripts (benchmarks/fig{8_noniid,11_approx_agg}.py) print it at that
# scale, seed 0, from the JAX package on the CPU through
# tools/reference_constants.py. figure_ext_mismatches holds the port to
# them: final_acc within FIGURE_EXT_ACC_BAND (twice the largest spread of
# a row's accuracy over the reference's seeds 0-2), fig11's disagreement
# under 1e-8 where the reference's is f32 rounding (exact MAR) and within
# a factor of 3 of it where the aggregation is approximate, every other
# field equal
FIGURE_EXT_ROWS = (
    ('fig8_partition', {'alpha': '0.1', 'mean_tv': '0.6987884414592002',
                        'max_tv': '0.7880696614583333', 'min_size': '274',
                        'max_size': '924'}),
    ('fig8_partition', {'alpha': '1.0', 'mean_tv': '0.2955856745361357',
                        'max_tv': '0.40388819515596536', 'min_size': '329',
                        'max_size': '660'}),
    ('fig8_partition', {'alpha': '100.0', 'mean_tv': '0.03941790572510225',
                        'max_tv': '0.051544070707684825', 'min_size': '495',
                        'max_size': '531'}),
    ('fig8_noniid', {'task': 'text', 'alpha': 'iid', 'final_acc': '0.0654'}),
    ('fig8_noniid', {'task': 'text', 'alpha': '1.0', 'final_acc': '0.0664'}),
    ('fig8_noniid', {'task': 'text', 'alpha': '0.1', 'final_acc': '0.0645'}),
    ('fig8_noniid', {'task': 'vision', 'alpha': 'iid', 'final_acc': '0.103'}),
    ('fig8_noniid', {'task': 'vision', 'alpha': '1.0', 'final_acc': '0.1016'}),
    ('fig8_noniid', {'task': 'vision', 'alpha': '0.1', 'final_acc': '0.106'}),
    ('fig11_approx', {'setting': 'exact_3^3', 'group_size': '3',
                      'rounds': 'exact', 'final_acc': '0.0664',
                      'comm_mb': '135.8', 'disagreement': '5.16e-10'}),
    ('fig11_approx', {'setting': 'approx_3x2', 'group_size': '3',
                      'rounds': '2', 'final_acc': '0.0664', 'comm_mb': '135.8',
                      'disagreement': '5.16e-10'}),
    ('fig11_approx', {'setting': 'approx_3x1', 'group_size': '3',
                      'rounds': '1', 'final_acc': '0.0693', 'comm_mb': '67.9',
                      'disagreement': '7.21e-07'}),
)
FIGURE_EXT_ACC_BAND = 2 * 0.0161
MAIN_PATH_D = (98304, 128, 2560, 20)    # fc1.w, fc1.b, fc2.w, fc2.b
# the extension runs whose kernel-off rerun must end within 1e-5. The
# others turn a 1e-7 difference into a step: int8 EF into a quantum, MKD
# into a teacher swap, DP into a flipped clipping indicator (the clip
# tracks a quantile of the peers' delta norms, so a norm sits within
# 1e-4 of it); theirs is printed, and every run's kernel is held against
# the kernel-off route on the same inputs in every aggregation instead
KERNEL_OFF_GATED = ("async", "elastic")
# The LM trainer (repro_torch.launch.train): the comm-total line the
# reference prints for each CPU CLI case (tools/reference_constants.py's
# TRAIN_CLI_CASES, "--smoke --steps 3 --peers 4 --seq 32" plus the
# case's flags; the socket's wall-clock seconds masked by wall_masked),
# and the ledger's total bytes of the full-width chip run
# below (musicgen-medium, 4 peers, 6 steps: 10,910,287,872 bytes of
# theta and m per peer), both from the JAX package on the CPU through
# tools/reference_constants.py
TRAIN_CLI_COMM = {
    "starcoder2-3b default": "[train] comm total=99.3MB agg/mar=99.3MB",
    "starcoder2-3b sessions": "[train] comm total=66.2MB agg/mar=66.2MB",
    "starcoder2-3b wireless": "[train] comm total=99.3MB agg/mar=99.3MB "
                              "comm_s=21.28 [simulated (wireless)]",
    "starcoder2-3b resize": "[train] comm total=74.4MB agg/mar=74.4MB",
    "musicgen-medium default": "[train] comm total=113.4MB "
                               "agg/mar=113.4MB",
    "musicgen-medium sessions": "[train] comm total=75.6MB agg/mar=75.6MB",
    "musicgen-medium wireless": "[train] comm total=113.4MB "
                                "agg/mar=113.4MB comm_s=24.30 "
                                "[simulated (wireless)]",
    "musicgen-medium resize": "[train] comm total=85.1MB agg/mar=85.1MB",
    "starcoder2-3b socket": "[train] comm total=99.3MB agg/mar=99.3MB "
                            "comm_s=<wall> [wall-clock]",
    "musicgen-medium socket": "[train] comm total=113.4MB "
                              "agg/mar=113.4MB comm_s=<wall> [wall-clock]",
}
# each rank's comm-total line of the two-rank socket world (TRAIN_CLI_BASE
# plus --transport socket --peer-hosts BOOK --rank R over a loopback book
# dealing nodes round-robin: each rank bills what its two nodes receive);
# same source
TRAIN_CLI_RANKS = {
    "starcoder2-3b": ("[train] comm total=49.6MB agg/mar=49.6MB "
                      "comm_s=<wall> [wall-clock]",) * 2,
}
TRAIN_CLI_BASE = ("--smoke", "--steps", "3", "--peers", "4", "--seq", "32")
TRAIN_CLI_CASES = {"default": (), "sessions": ("--churn", "sessions"),
                   "wireless": ("--link-profile", "wireless",
                                "--link-loss", "0.1"),
                   "resize": ("--resize-at", "2:2"),
                   "socket": ("--transport", "socket")}
# The trainer's large-N flags at 16 peers: each CPU CLI case's regroup
# and comm-total lines as the reference prints them (same source; the
# schedule case's controller is ScheduleController, injected in both
# packages, regrouping (2, 2, 2, 2) -> (4, 4) after step 1)
TRAIN_CLI_LARGE_N_BASE = ("--arch", "starcoder2-3b", "--smoke", "--steps",
                          "3", "--peers", "16", "--seq", "16")
TRAIN_CLI_LARGE_N_SCHEDULE = ((0, (4, 4)),)
TRAIN_CLI_LARGE_N = {
    "adaptive_m": (
        ("--link-profile", "wireless", "--adaptive-m", "tail_aware"),
        ("[train] comm total=794.1MB agg/mar=794.1MB comm_s=77.97 "
         "[simulated (wireless)]",)),
    "placement": (
        ("--link-profile", "regions", "--link-shuffle", "--placement",
         "clustered"),
        ("[train] placement regroup at step 1: 13/16 peers moved",
         "[train] comm total=854.1MB agg/mar=794.1MB placement_probe=60.0MB"
         " comm_s=95.88 [simulated (regions)]")),
    "vector_sim": (
        ("--link-profile", "wireless", "--link-loss", "0.1", "--transport",
         "vector_sim"),
        ("[train] comm total=794.1MB agg/mar=794.1MB comm_s=77.97 "
         "[simulated (wireless)]",)),
    "super_sim": (
        ("--link-profile", "regions", "--link-shuffle", "--placement",
         "clustered", "--adaptive-m", "tail_aware", "--transport",
         "super_sim"),
        ("[train] placement regroup at step 1: 13/16 peers moved",
         "[train] comm total=854.1MB agg/mar=794.1MB placement_probe=60.0MB"
         " comm_s=95.88 [simulated (regions)]")),
    "schedule": (
        ("--link-profile", "wireless", "--adaptive-m", "schedule"),
        ("[train] adaptive-M regroup at step 1: (2, 2, 2, 2) -> (4, 4)",
         "[train] comm total=1058.7MB agg/mar=1058.7MB comm_s=103.91 "
         "[simulated (wireless)]")),
}
TRAIN_COMM_BYTES = 523_693_817_856
# The recurrent families trained at full width by the train_recurrent
# phase (TRAIN_ARGS' traffic: 4 peers on (2, 2), batch 2 of 128 tokens, 6
# steps): parameters a peer (the reference's ModelConfig.param_count()),
# the ledger's total bytes (same source), and per step the SSD-scan and
# flash launches: every Mamba2 / mLSTM layer and every application of
# zamba2's shared attention block, per peer, in the forward and again in
# the remat recompute — except zamba2's shared attention block, which the
# reference does not rematerialize (jax.checkpoint wraps the Mamba2
# blocks only), so flash runs once per application a peer — and the
# SSD backward kernel's launches, two a Mamba2 layer and peer (zamba2's
# dk = dv = 64; xlstm's mLSTM, dk 512, takes the plain VJP). The
# parameters are the tree's, as Model.init
# draws them (the reference's ModelConfig.param_count() is an estimate
# here: 2,194,295,840 and 527,905,792)
TRAIN_RECURRENT = {
    "zamba2-2.7b": dict(params=2_063_209_520, comm_bytes=594_205_378_560,
                        ssd_per_step=45 * 2 * 4, ssd_bwd_per_step=45 * 4 * 2,
                        flash_per_step=9 * 4, mar_rounds_per_step=19 * 2),
    "xlstm-350m": dict(params=518_640_640, comm_bytes=149_704_704_000,
                       ssd_per_step=21 * 2 * 4, ssd_bwd_per_step=0,
                       flash_per_step=0, mar_rounds_per_step=16 * 2),
}
# The published Zamba2-2.7B (models/zamba2.py; the benchmark's
# configuration zamba2-2.7b, 2,662,214,560 parameters in 22 leaves)
# trained as the cell zamba2-2.7b.fl_train_4k trains it: 2 peers on the
# grid (2,), one local step of 1 x 4,096 tokens; per step, flash in the
# forward and remat recompute of the 9 shared-block applications of each
# peer, the SSD scan in those of the 54 Mamba2 layers and its backward
# kernel once a layer and peer (two launches), mar_rounds once a leaf of
# theta and of m
ZAMBA2_PUBLISHED = dict(config="zamba2-2.7b", peers=2, seq=4096, steps=3,
                        params=2_662_214_560, flash_per_step=9 * 2 * 2,
                        ssd_per_step=54 * 2 * 2, ssd_bwd_per_step=54 * 2 * 2,
                        mar_rounds_per_step=22 * 2)
# The federation_large_n runs: the paper's text model under adaptive
# group sizing at N = 125 on each transport, and clustered placement at
# N = 64 on shuffled regions; the kernel on, 20 iterations. The
# reference's ledger by source, sim_seconds, regroup and placement logs
# at seed 0 and the accuracy band at iteration 20 (seeds 0-2 widened by
# their spread plus 0.05, as EXTENSION_REF), from the JAX package on the
# CPU through tools/reference_constants.py
LARGE_N_RUNS = {
    "adaptive_sim": dict(n_peers=125, task="text", adaptive_m="tail_aware",
                         link_profile="wireless", transport="sim"),
    "adaptive_vector_sim": dict(n_peers=125, task="text",
                                adaptive_m="tail_aware",
                                link_profile="wireless",
                                transport="vector_sim"),
    "adaptive_super_sim": dict(n_peers=125, task="text",
                               adaptive_m="tail_aware",
                               link_profile="wireless",
                               transport="super_sim"),
    "placement_vector_sim": dict(n_peers=64, task="text",
                                 placement="clustered",
                                 link_profile="regions",
                                 link_params={"shuffle": True},
                                 transport="vector_sim"),
}
_ADAPTIVE_REF = dict(
    comm_bytes=16_439_905_024, sim_seconds=243.53785902920532,
    by_source={"agg/mar": 16_439_905_024},
    regroup_log=[[3, [5, 5, 5], [3, 3, 3, 3, 3]],
                 [7, [3, 3, 3, 3, 3], [2, 2, 2, 2, 2, 2, 2]]],
    placement_log=[],
    band=(0.0867, 0.2307))    # seeds 0-2: 0.1631, 0.166, 0.1514
LARGE_N_REF = {
    "adaptive_sim": _ADAPTIVE_REF,
    "adaptive_vector_sim": _ADAPTIVE_REF,
    "adaptive_super_sim": _ADAPTIVE_REF,
    "placement_vector_sim": dict(
        comm_bytes=6_458_177_280, sim_seconds=220.870892961519,
        by_source={"agg/mar": 6_206_177_280,
                   "placement_probe": 252_000_000},
        regroup_log=[], placement_log=[[0, 62]],
        band=(0.074, 0.2502)),   # seeds 0-2: 0.1729, 0.1748, 0.1494
}
TRAIN_ARGS = ("--arch", "musicgen-medium", "--peers", "4", "--batch", "2",
              "--seq", "128", "--local-steps", "1", "--steps", "6",
              "--seed", "0")
TRAIN_PARAMS = 1_818_379_776     # the reference's ModelConfig.param_count()
TRAIN_LAYERS = 48
# flash launches a step: every attention layer of every peer runs the
# forward kernel once in the forward and once more when the backward
# recomputes its block (cfg.remat == "block"); local steps and
# microbatches are 1
TRAIN_FLASH_PER_STEP = TRAIN_LAYERS * 4 * 2
TRAIN_TOKENS_PER_STEP = 4 * 2 * 128
# mar_rounds launches a step: the device aggregation runs every round of
# a leaf in one launch, one a leaf of theta and one of m
TRAIN_MAR_ROUNDS_PER_STEP = 13 * 2
# train_mesh (a): the train phase's first steps again, on a DTensor state
TRAIN_MESH_STEPS = 3
TRAIN_MESH_COMM_BYTES = TRAIN_COMM_BYTES * TRAIN_MESH_STEPS // 6
TRAIN_MESH_PEAK_BYTES = 80e9


def wall_masked(line: str) -> str:
    """A trainer's comm-total line with its wall-clock seconds (the
    socket transport's, which no two runs share) masked."""
    import re

    return re.sub(r"comm_s=[0-9.]+ \[wall-clock\]",
                  "comm_s=<wall> [wall-clock]", line)


def figure_ext_mismatches(rows) -> list:
    """How the Fig. 8 and 11 rows of ``rows`` (``figures.run_figures``'s
    dicts) part from FIGURE_EXT_ROWS; empty where they agree."""
    got = [r for r in rows if r["row"] in ("fig8_partition", "fig8_noniid",
                                           "fig11_approx")]
    if [r["row"] for r in got] != [name for name, _ in FIGURE_EXT_ROWS]:
        return [f"rows {[r['row'] for r in got]}"]
    bad = []
    for r, (name, want) in zip(got, FIGURE_EXT_ROWS):
        if sorted(k for k in r if k != "row") != sorted(want):
            bad.append(f"{name} keys {sorted(r)}")
            continue
        for key, value in want.items():
            have = str(r[key])
            if key == "final_acc":
                ok = abs(float(have) - float(value)) <= FIGURE_EXT_ACC_BAND
            elif key == "disagreement":
                ref = float(value)
                ok = (float(have) < 1e-8 if ref < 1e-8
                      else ref / 3 <= float(have) <= 3 * ref)
            else:
                ok = have == value
            if not ok:
                bad.append(f"{name} {key}={have}, the reference's {value}")
    return bad


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, reps: int = 20, warmup: int = 3,
              flush=None, spin: int = 2_000_000) -> float:
    """Median device time of ``reps`` calls of ``fn``. Before each, the
    card spins for ``spin`` cycles, about a millisecond by default
    (``torch.cuda._sleep``), while the host queues the start event, the
    call and the end event, so the interval holds the call's kernels and
    not the host's Python (a call that queues many launches needs a
    longer spin). With ``flush`` (a tensor larger than the L2 cache) it
    is overwritten before each call, so the call finds its inputs in
    device memory as the model's layers do."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def group_mean_bound_ms(g: int, m: int, d: int, itemsize: int) -> dict:
    """Least time for the masked group mean, the larger of two: x read
    once, mask read once and y written once over HBM (``bytes_ms``); a
    multiply-add per element read and a divide per column over the f32
    rate (``ops_ms``)."""
    nbytes = 2 * g * m * d * itemsize + g * m * 4
    flops = 2 * g * m * d + g * d
    return {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": flops / F32_FLOP_PER_S * 1e3}


def phase_group_mean(torch, gm, ref, flush):
    cases = [("path", d, torch.float32) for d in MAIN_PATH_D] + [
        ("bf16", 98304, torch.bfloat16), ("tail", 1000, torch.float32),
        ("d1", 1, torch.float32)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for kind, d, dtype in cases:
        g, m = 9, 3
        x = torch.randn((g, m, d), generator=gen, device="cuda").to(dtype)
        mask = (torch.rand((g, m), generator=gen, device="cuda") < 0.7)
        mask = mask.float()
        mask[-1] = 0.0                  # a fully dropped group
        mask[0, 0] = 1.0
        y = gm.group_mean_fwd(x, mask)
        want = ref.group_mean_ref(x, mask)
        torch.cuda.synchronize()
        err = float((y.float() - want.float()).abs().max())
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        check(y.dtype == dtype and y.shape == x.shape,
              f"group_mean {kind} D={d}: bad output {y.dtype} {y.shape}")
        check(err <= tol, f"group_mean {kind} D={d} {dtype}: max abs err "
                          f"{err} > {tol}")
        check(torch.equal(y[-1], x[-1]),
              f"group_mean {kind} D={d}: dropped group changed")
        bound = group_mean_bound_ms(g, m, d, x.element_size())
        row = {"kind": kind, "G": g, "M": m, "D": d,
               "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err, "tol": tol,
               "kernel_ms": device_ms(
                   torch, lambda: gm.group_mean_fwd(x, mask), flush=flush),
               "plain_ms": device_ms(
                   torch, lambda: ref.group_mean_ref(x, mask), flush=flush),
               "bound_ms": max(bound.values()), **bound}
        row.update(shares(row["kernel_ms"], row["bound_ms"], None))
        rows.append(row)
        emit("group_mean", **row)
    return rows


# the quickstart's tree: theta and momentum of the MLP head 768->128->20
MLP_SHAPES = {"fc1": {"w": (768, 128), "b": (128,)},
              "fc2": {"w": (128, 20), "b": (20,)}}
# leaf widths of the >MAX_LEAVES tree: vector and scalar paths, d = 1
MIXED_D = (1, 3, 20, 128, 999, 1000, 2560, 4097)


def group_mean_round_bound_ms(leaves, cap: int, m: int) -> dict:
    """Least time for one MAR round over ``leaves`` ([n, ...] each), the
    larger of two: every leaf read once and written once, the mask [n]
    and the order [cap] read once, over HBM (``bytes_ms``); a
    multiply-add per element read and a divide per group column over
    the f32 rate (``ops_ms``). Virtual slots move nothing."""
    n = leaves[0].shape[0]
    nbytes = sum(2 * x.numel() * x.element_size() for x in leaves) \
        + n * 4 + cap * 8
    flops = sum(2 * x.numel() + cap // m * (x.numel() // max(n, 1))
                for x in leaves)
    return {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": flops / F32_FLOP_PER_S * 1e3}


def _round_tree(torch, gen, kind: str, n: int):
    """A tree of [n, ...] leaves on the card for one group_mean_round
    row: the quickstart's theta and momentum (f32 or bf16), or more than
    MAX_LEAVES leaves mixing f32 and bf16, with two offset views that
    are not 16-byte aligned."""
    from repro_torch.kernels.group_mean import MAX_LEAVES

    def draw(shape, dtype=torch.float32, offset=0):
        flat = torch.randn(n * math.prod(shape) + offset, generator=gen,
                           device="cuda").to(dtype)
        return flat[offset:].view((n,) + tuple(shape))

    if kind in ("quickstart", "virtual", "bf16"):
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        return {k: {layer: {name: draw(shape, dtype)
                            for name, shape in p.items()}
                    for layer, p in MLP_SHAPES.items()}
                for k in ("p", "m")}
    f32 = {f"f{i:02d}": draw((MIXED_D[i % len(MIXED_D)],))
           for i in range(MAX_LEAVES + 4)}
    f32["f_offset"] = draw((1000,), offset=1)
    bf16 = {f"h{i}": draw((d,), torch.bfloat16)
            for i, d in enumerate((1, 20, 2560))}
    bf16["h_offset"] = draw((2560,), torch.bfloat16, offset=3)
    return {"f32": f32, "bf16": bf16}


def _parent_route(torch, gm, x, order, inv, mask_g, n, cap, m):
    """One leaf through the route the round kernel replaced: pad, gather
    by order, the [G, M, D] entry, gather back by inv."""
    xf = x.reshape(n, -1)
    d = xf.shape[1]
    if cap > n:
        xf = torch.cat([xf, xf.new_zeros((cap - n, d))])
    out = gm.group_mean_fwd(xf[order].reshape(cap // m, m, d), mask_g)
    return out.reshape(cap, d)[inv][:n].reshape(x.shape)


def phase_group_mean_round(torch, flush):
    """The round kernel through ``_kernel_round`` (the main path's entry)
    against the round's plain version, at the quickstart's tree (N=27 on
    3x3x3, every round), N=26 on the same grid (virtual slots), the tree
    in bf16, and a tree of more than MAX_LEAVES leaves mixing f32 and
    bf16 (scalar and offset leaves too). Each mask drops one whole
    group, which must keep its rows bit for bit; f32 and bf16 must be
    bit-equal to the route the kernel replaced (gather, [G, M, D]
    entry, scatter). Times with L2 flushed: the kernel, that route, the
    plain version and the kernel-off route (grouped sums)."""
    from repro_torch.core import mar_allreduce as mar
    from repro_torch.core.moshpit import GridPlan
    from repro_torch.kernels import group_mean as gm
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import group_mean_round_ref
    from repro_torch.tree import tree_leaves

    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [("quickstart", 27, r) for r in range(3)] + \
        [("virtual", 26, r) for r in range(3)] + \
        [("bf16", 27, 0), ("mixed", 27, 1)]
    rows = []
    for kind, n, rnd in cases:
        plan = GridPlan(n, (3, 3, 3))
        cap, m = plan.capacity, plan.dims[rnd]
        state = _round_tree(torch, gen, kind, n)
        leaves = tree_leaves(state)
        ri = mar.round_index(plan, rnd, torch.device("cuda"))
        order, inv = ri.order, ri.inv
        mask = (torch.rand(n, generator=gen, device="cuda") < 0.7).float()
        # drop the whole group of the last slot (a virtual one at N=26)
        slots = order.tolist()
        g_drop = slots.index(cap - 1) // m
        drop_slots = slots[g_drop * m:(g_drop + 1) * m]
        drop = [p for p in drop_slots if p < n]
        mask[drop] = 0.0
        keep = [p for p in range(n) if p not in drop_slots]
        mask[keep[0]] = 1.0
        mask_g = torch.cat([mask, mask.new_zeros(cap - n)])[order] \
            .reshape(cap // m, m)

        ops.reset_launch_counts()
        out = tree_leaves(mar._kernel_round(state, plan, rnd, mask))
        torch.cuda.synchronize()
        launches = ops.launch_counts()["group_mean"]
        flat = [x.reshape(n, -1) for x in leaves]
        want = [None] * len(flat)
        for idx in gm.batches(flat):
            for i, y in zip(idx, group_mean_round_ref(
                    [flat[i] for i in idx], order, mask, m)):
                want[i] = y.reshape(leaves[i].shape)
        parent = [_parent_route(torch, gm, x, order, inv, mask_g, n, cap, m)
                  for x in leaves]
        torch.cuda.synchronize()
        err, tol = 0.0, 0.0
        for x, y, w, pr in zip(leaves, out, want, parent):
            t = _tol(torch, x.dtype)
            tol = max(tol, t)
            e = float((y.float() - w.float()).abs().max())
            err = max(err, e)
            check(y.dtype == x.dtype and y.shape == x.shape
                  and bool(torch.isfinite(y).all()),
                  f"group_mean_round {kind} r{rnd}: bad output {y.dtype} "
                  f"{tuple(y.shape)}")
            check(e <= t, f"group_mean_round {kind} r{rnd} {x.dtype}: max "
                          f"abs err {e} > {t}")
            check(torch.equal(y, pr), f"group_mean_round {kind} r{rnd} "
                                      f"{x.dtype}: not bit-equal to the "
                                      f"gather / [G, M, D] / scatter route")
            check(torch.equal(y[drop], x[drop]),
                  f"group_mean_round {kind} r{rnd}: dropped group changed")
        want_launches = len(gm.batches(flat))
        check(launches == want_launches,
              f"group_mean_round {kind} r{rnd}: {launches} launches, "
              f"expected {want_launches}")

        def kernel():
            return mar._kernel_round(state, plan, rnd, mask)

        def parent_route():
            return [_parent_route(torch, gm, x, order, inv, mask_g, n, cap,
                                  m) for x in leaves]

        def plain():
            return [group_mean_round_ref([flat[i] for i in idx], order,
                                         mask, m)
                    for idx in gm.batches(flat)]

        def kernel_off():
            return mar.mar_round_sim(state, plan, rnd, mask)

        host_us = {}
        for name, fn in (("kernel", kernel), ("parent_route", parent_route)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            host_us[name] = (time.perf_counter() - t0) / 50 * 1e6
            torch.cuda.synchronize()
        spin = 20_000_000        # ~12 ms: the multi-launch routes' host
        bound = group_mean_round_bound_ms(leaves, cap, m)
        row = {"kind": kind, "n": n, "grid": list(plan.dims), "round": rnd,
               "leaves": len(leaves), "launches": launches,
               "dtypes": sorted({str(x.dtype).replace("torch.", "")
                                 for x in leaves}),
               "dropped_peers": drop, "max_abs_err": err, "tol": tol,
               "bit_equal_to_parent_route": True,
               "kernel_ms": device_ms(torch, kernel, flush=flush),
               "parent_route_ms": device_ms(torch, parent_route,
                                            flush=flush, spin=spin),
               "plain_ms": device_ms(torch, plain, flush=flush, spin=spin),
               "kernel_off_ms": device_ms(torch, kernel_off, flush=flush,
                                          spin=spin),
               "library_ms": None,
               "host_us_per_round": host_us["kernel"],
               "parent_route_host_us_per_round": host_us["parent_route"],
               "bound_ms": max(bound.values()), **bound}
        row.update(shares(row["kernel_ms"], row["bound_ms"], None))
        rows.append(row)
        emit("group_mean_round", **row)
    return rows


def mar_rounds_bound_ms(leaves, rounds: int) -> dict:
    """Least time for the device MAR aggregation of ``leaves`` ([P, ...]
    each), the larger of two: every leaf read once and written once
    however many rounds run, and the mask once, over HBM
    (``bytes_ms``); a multiply-add and a divide per element and round
    over the f32 rate (``ops_ms``)."""
    nbytes = sum(2 * x.numel() * x.element_size() for x in leaves) \
        + leaves[0].shape[0] * 4
    flops = 3 * rounds * sum(x.numel() for x in leaves)
    return {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": flops / F32_FLOP_PER_S * 1e3}


def phase_mar_rounds(torch, flush):
    """The device MAR aggregation of the train phase's state through the
    in-place rounds kernel: theta (bf16) and m (f32) of 4 peers of
    musicgen-medium at full width (43.6 GB), random on the card, on the
    (2, 2) grid. Leaf by leaf, ``mar_rounds_`` (both rounds, one launch)
    against its plain version (``ref.mar_rounds_ref``, column block by
    column block) under a full mask and one that empties a group:
    bit-equal (groups of two). Then the whole state through
    ``mar_aggregate_device`` with the kernel and with the plain route
    (``_takes_kernel`` off), L2 flushed, beside the bound: one launch a
    leaf, and the kernel allocates nothing. Returns the row."""
    import gc
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.core import mar_allreduce as mar
    from repro_torch.core.fl_device import fl_state_shape
    from repro_torch.core.moshpit import plan_grid
    from repro_torch.kernels import mar_rounds
    from repro_torch.kernels.ref import mar_rounds_ref
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves

    n, plan = 4, plan_grid(4)
    dims, axes = plan.dims, tuple(range(plan.depth))
    check(dims == (2, 2), f"mar_rounds: grid {dims}")
    shape = fl_state_shape(Model(get_config("musicgen-medium")), n)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = {k: tuple(torch.randn(x.shape, generator=gen, device="cuda")
                      .to(x.dtype) for x in tree_leaves(shape[k]))
             for k in ("params", "momentum")}
    leaves = tree_leaves(state)
    empty = torch.ones(n, device="cuda")
    first = mar_rounds.groups(dims, (0,))[0][0]
    for q in range(n):
        if first >> q & 1:
            empty[q] = 0.0
    err, unequal = 0.0, []
    for name, mask in (("full", torch.ones(n, device="cuda")),
                       ("empty_group", empty)):
        for i, x in enumerate(leaves):
            x2 = x.view(n, -1)
            got = x2.clone()
            mar_rounds.launches = 0
            mar_rounds.mar_rounds_(got, dims, axes, mask)
            check(mar_rounds.launches == 1,
                  f"mar_rounds {name} leaf {i}: {mar_rounds.launches} "
                  f"launches")
            for c0 in range(0, x2.shape[1], 1 << 24):
                want = mar_rounds_ref(x2[:, c0:c0 + (1 << 24)], dims, axes,
                                      mask)
                blk = got[:, c0:c0 + (1 << 24)]
                err = max(err, float((blk.float() - want.float())
                                     .abs().max()))
                if not torch.equal(blk, want):
                    unequal.append(f"{name} leaf {i} {x.dtype} "
                                   f"{tuple(x.shape)} column {c0}")
                del want
            del got
    plain = mock.patch.object(mar, "_takes_kernel", lambda *a: False)

    def kernel_route():
        mar.mar_aggregate_device(state, plan)

    def plain_route():
        with plain:
            mar.mar_aggregate_device(state, plan)

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    mar_rounds.launches = 0
    kernel_route()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - before
    launches = mar_rounds.launches
    # a spin of ~10 ms: the plain route queues thousands of launches
    kernel_ms = device_ms(torch, kernel_route, reps=10, warmup=1,
                          flush=flush, spin=20_000_000)
    plain_ms = device_ms(torch, plain_route, reps=3, warmup=1,
                         flush=flush, spin=20_000_000)
    bound = mar_rounds_bound_ms(leaves, len(axes))
    row = {"kind": "musicgen-medium theta and m, 4 peers on (2, 2)",
           "leaves": len(leaves),
           "params_per_peer": sum(x[0].numel() for x in state["params"]),
           "state_bytes": sum(x.numel() * x.element_size()
                              for x in leaves),
           "max_abs_err": err, "not_bit_equal": unequal[:8],
           "launches_a_call": launches, "allocated_by_call": allocated,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": None, "bound_ms": max(bound.values()), **bound}
    row.update(shares(kernel_ms, row["bound_ms"], None))
    emit("mar_rounds", **row)
    check(not unequal, f"mar_rounds: not bit-equal to the plain version "
                       f"(max abs err {err}): {unequal[:8]}")
    check(launches == len(leaves),
          f"mar_rounds: {launches} launches for {len(leaves)} leaves")
    check(allocated == 0, f"mar_rounds: the call allocated {allocated} B")
    del state, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return row


def run_quickstart(torch, Federation, cfg, ops, iterations: int = 20):
    fed = Federation(cfg)           # the default device: cuda
    state = fed.init_state()
    accs, step_s = [], []
    ops.reset_launch_counts()
    for t in range(iterations):
        t0 = time.perf_counter()
        state = fed.step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if (t + 1) % 5 == 0:
            accs.append(fed.evaluate(state))
    launches = ops.launch_counts()["group_mean"]
    return fed, state, accs, step_s, launches


def phase_federation(torch, smi):
    from repro_torch.core.federation import Federation
    from repro_torch.kernels import ops
    from repro_torch.kernels.group_mean import batches
    from repro_torch.quickstart import quickstart_config
    from repro_torch.tree import tree_leaves

    cfg = quickstart_config(kernel_group_mean=True)
    fed, state, accs, step_s, launches = run_quickstart(
        torch, Federation, cfg, ops)
    # one launch per round for each dtype batch of theta and m's leaves
    per_round = len(batches(tree_leaves({"p": state.params,
                                         "m": state.momentum})))
    want_launches = 20 * fed.plan.depth * per_round
    dis = fed.peer_disagreement(state)
    out = {"n_peers": cfg.n_peers, "grid": list(fed.plan.dims),
           "accuracy_every_5": accs, "disagreement": dis,
           "comm_bytes": fed.comm_bytes, "sim_seconds": fed.sim_seconds,
           "launches": launches, "expected_launches": want_launches,
           "first_step_ms": step_s[0] * 1e3,
           "ms_per_iteration": statistics.median(step_s[1:]) * 1e3,
           "card": smi}
    emit("federation", **out)
    check(want_launches == 60, f"expected 60 launches, plan gives "
                               f"{want_launches}")
    check(launches == want_launches,
          f"group_mean launched {launches} times on the main path, "
          f"expected {want_launches}")
    check(accs[-1] >= 0.30, f"accuracy {accs[-1]} < 0.30 at iteration 20")
    check(dis <= 1e-10, f"peer disagreement {dis} > 1e-10")
    check(fed.comm_bytes == QUICKSTART_BYTES,
          f"comm_bytes {fed.comm_bytes} != {QUICKSTART_BYTES}")
    check(abs(fed.sim_seconds - QUICKSTART_SIM_S) <= 1e-9,
          f"sim_seconds {fed.sim_seconds} != {QUICKSTART_SIM_S}")

    _, state_off, accs_off, step_off, launches_off = run_quickstart(
        torch, Federation, quickstart_config(kernel_group_mean=False), ops)
    diff = max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(state.params), tree_leaves(state_off.params)))
    emit("federation_kernel_off", max_param_diff_vs_kernel=diff,
         accuracy_every_5=accs_off, launches=launches_off,
         ms_per_iteration=statistics.median(step_off[1:]) * 1e3, card=smi)
    check(launches_off == 0, f"kernel-off run launched {launches_off}")
    check(diff <= 1e-5, f"kernel on/off params differ by {diff} > 1e-5")
    return launches


def _socket_quickstart(torch, cfg, ops, each=None, iterations: int = 20
                       ) -> dict:
    """The quickstart config ``cfg`` over the socket transport for
    ``iterations`` steps, the counts set to 0 just before and read just
    after; ``each(t, fed, state)`` runs after every step, outside the
    timed region. Returns the federation, the state, step seconds, the
    accuracy at the end, the group-mean launches and the frames' payload
    bytes."""
    from repro_torch.core.federation import Federation

    fed = Federation(cfg)
    state = fed.init_state()
    step_s, payload = [], 0
    ops.reset_launch_counts()
    for t in range(iterations):
        t0 = time.perf_counter()
        state = fed.step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        payload += fed.last_transcript.payload_bytes
        if each is not None:
            each(t, fed, state)
    launches = ops.launch_counts()["group_mean"]
    return {"fed": fed, "state": state, "step_s": step_s,
            "accuracy": fed.evaluate(state), "launches": launches,
            "payload_bytes": payload}


def _socket_trainer(torch, smi, tmp: str) -> dict:
    """``launch.train`` over the socket transport at starcoder2-3b's
    smoke config: once in process (flash counted), then as two rank
    processes of one loopback book on the card. Each comm-total line,
    wall-clock masked, is the reference's. Returns the in-process run's
    flash and mar_rounds launches."""
    import contextlib
    import io
    import os

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.runtime.socket_transport import AddressBook

    argv = ["--arch", "starcoder2-3b", *TRAIN_CLI_BASE,
            *TRAIN_CLI_CASES["socket"]]
    cfg = get_smoke_config("starcoder2-3b")
    # 3 steps x 4 peers x every layer, forward and remat recompute
    want_flash = 3 * 4 * cfg.num_layers * (2 if cfg.remat == "block" else 1)
    buf = io.StringIO()
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    counts = {k: ops.launch_counts()[k]
              for k in ("flash_attention", "mar_rounds")}
    flash = counts["flash_attention"]
    one_s = time.perf_counter() - t0
    line = wall_masked(next(ln for ln in buf.getvalue().splitlines()
                            if ln.startswith("[train] comm total=")))
    check(rc == 0, "federation_socket trainer: main did not return 0")
    check(line == TRAIN_CLI_COMM["starcoder2-3b socket"],
          f"federation_socket trainer: {line!r}")
    check(flash == want_flash, f"federation_socket trainer: flash launched "
                               f"{flash} times, expected {want_flash}")

    book = os.path.join(tmp, "book.json")
    AddressBook.loopback(4, world_size=2).to_json(book)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv,
         "--peer-hosts", book, "--rank", str(r)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    two_s = time.perf_counter() - t0
    lines = [[wall_masked(ln) for ln in out.splitlines()
              if ln.startswith("[train] comm total=")] for out, _ in outs]
    emit("federation_socket_trainer", args=argv, flash_launches=flash,
         mar_rounds_launches=counts["mar_rounds"],
         in_process_s=one_s, two_rank_s=two_s,
         rank_lines=lines, rank_rcs=[p.returncode for p in procs],
         card=smi)
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"federation_socket rank {r} exited "
                                 f"{p.returncode}: {err[-2000:]}")
        check(lines[r] == [TRAIN_CLI_RANKS["starcoder2-3b"][r]],
              f"federation_socket rank {r}: {lines[r]}")
    return counts


def phase_federation_socket(torch, smi):
    """The federation and the trainer over the real TCP transport.

    1. The quickstart (kernel on) over ``transport="socket"`` in
       loopback mode, 20 iterations: theta and m after every iteration
       bit-equal to the sim route's (a lossless transport changes no
       mask), the reference's ledger, 60 group-mean launches, accuracy
       >= 0.30, the frames' payload bytes equal to the billed bytes, and
       the blobs of iteration 0 encoded on the card byte-equal to the
       same state's encoded on the CPU; ms per iteration beside the sim
       route's.
    2. The same under injected loss (SOCKET_LOSSY): each iteration's
       lost senders and the ledger by source the reference's
       (SOCKET_REF), accuracy in its band, 60 launches.
    3. ``run_multiprocess`` (two spawned ranks on a loopback book) over
       the quickstart's mar, ar and fedavg plans, byte-exact against the
       sim; then ``python -m repro_torch.transport_calibration --smoke``
       exits 0.
    4. The trainer over socket, in process and as two rank processes
       (``_socket_trainer``).
    Returns (group-mean launches, flash launches)."""
    import dataclasses
    import os
    import tempfile

    import numpy as np

    from repro_torch.core.aggregation import build_pipeline
    from repro_torch.core.federation import Federation
    from repro_torch.kernels import ops
    from repro_torch.quickstart import quickstart_config
    from repro_torch.runtime.socket_transport import (encode_state_payloads,
                                                      run_multiprocess)
    from repro_torch.runtime.transport_base import build_transport
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = quickstart_config(kernel_group_mean=True)
    sim = Federation(cfg)
    state = sim.init_state()
    sim_s, sim_trees = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        state = sim.step(state)
        torch.cuda.synchronize()
        sim_s.append(time.perf_counter() - t0)
        sim_trees.append([x.clone() for x in tree_leaves(
            {"p": state.params, "m": state.momentum})])

    first = Federation(dataclasses.replace(cfg, transport="socket"))
    params0 = first.init_state().params
    blobs_card = encode_state_payloads(params0)
    blobs_cpu = encode_state_payloads(tree_map(lambda x: x.cpu(), params0))
    diverged = []

    def same_as_sim(t, fed, st):
        got = tree_leaves({"p": st.params, "m": st.momentum})
        if not all(torch.equal(x, y) for x, y in zip(got, sim_trees[t])):
            diverged.append(t)

    run = _socket_quickstart(torch, dataclasses.replace(
        cfg, transport="socket"), ops, each=same_as_sim)
    fed = run["fed"]
    out = {"n_peers": cfg.n_peers, "grid": list(fed.plan.dims),
           "comm_bytes": fed.comm_bytes,
           "payload_bytes": run["payload_bytes"],
           "wall_clock_comm_s": fed.sim_seconds,
           "accuracy": run["accuracy"], "launches": run["launches"],
           "diverged_iterations": diverged,
           "blob_bytes": len(blobs_card[0]),
           "blobs_card_equal_cpu": blobs_card == blobs_cpu,
           "first_step_ms": run["step_s"][0] * 1e3,
           "ms_per_iteration": statistics.median(run["step_s"][1:]) * 1e3,
           "sim_ms_per_iteration": statistics.median(sim_s[1:]) * 1e3,
           "card": smi}
    emit("federation_socket", **out)
    check(not diverged, f"federation_socket: theta or m differ from the "
                        f"sim route after iterations {diverged}")
    check(fed.comm_bytes == QUICKSTART_BYTES,
          f"federation_socket: comm_bytes {fed.comm_bytes}")
    check(run["payload_bytes"] == fed.comm_bytes,
          f"federation_socket: payload {run['payload_bytes']} != billed "
          f"{fed.comm_bytes}")
    check(run["launches"] == 60,
          f"federation_socket: {run['launches']} group-mean launches")
    check(run["accuracy"] >= 0.30,
          f"federation_socket: accuracy {run['accuracy']} < 0.30")
    check(blobs_card == blobs_cpu and len(blobs_card) == cfg.n_peers,
          "federation_socket: the card's payload blobs differ from the "
          "CPU's")
    launches = run["launches"]

    lost = []
    lossy = _socket_quickstart(
        torch, dataclasses.replace(cfg, **SOCKET_LOSSY), ops,
        each=lambda t, f, st: lost.append(sum(
            1 << int(i) for i in f.last_transcript.lost_senders.nonzero()[0])))
    lo, hi = SOCKET_REF["band"]
    emit("federation_socket_lossy", link_params=SOCKET_LOSSY["link_params"],
         lost_senders=lost, by_source=dict(lossy["fed"].ledger.by_source),
         accuracy=lossy["accuracy"], band=[lo, hi],
         launches=lossy["launches"],
         ms_per_iteration=statistics.median(lossy["step_s"][1:]) * 1e3,
         card=smi)
    check(lost == SOCKET_REF["lost_senders"],
          f"federation_socket lossy: lost senders {lost}")
    check(dict(lossy["fed"].ledger.by_source) == SOCKET_REF["by_source"],
          f"federation_socket lossy: ledger {lossy['fed'].ledger.by_source}")
    check(lo <= lossy["accuracy"] <= hi,
          f"federation_socket lossy: accuracy {lossy['accuracy']} outside "
          f"[{lo}, {hi}]")
    check(lossy["launches"] == 60,
          f"federation_socket lossy: {lossy['launches']} launches")
    launches += lossy["launches"]

    mask = np.ones(cfg.n_peers, np.float32)
    techs = ("mar", "ar", "fedavg")
    plans = [build_pipeline(t, sim.plan).message_plan(
        mask, sim.model_bytes, cfg.n_peers) for t in techs]
    t0 = time.perf_counter()
    merged = run_multiprocess(cfg.n_peers, plans, world_size=2)
    mp_s = time.perf_counter() - t0
    net = build_transport("sim", cfg.n_peers, profile="uniform")
    exact = {}
    for tech, p, tr in zip(techs, plans, merged):
        ref = net.run(p)
        exact[tech] = (tr.total_bytes == ref.total_bytes
                       and tr.bytes_by_round == ref.bytes_by_round
                       and tr.bytes_by_link == ref.bytes_by_link
                       and tr.n_messages == ref.n_messages)
    t0 = time.perf_counter()
    cal = subprocess.run(
        [sys.executable, "-m", "repro_torch.transport_calibration",
         "--smoke"], env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=600)
    emit("federation_socket_2proc", plans=list(techs), byte_exact=exact,
         bytes=[int(tr.total_bytes) for tr in merged], seconds=mp_s,
         calibration_rc=cal.returncode,
         calibration_s=time.perf_counter() - t0,
         calibration_summary=cal.stdout.strip().splitlines()[-1:],
         card=smi)
    check(all(exact.values()), f"federation_socket 2proc: {exact}")
    check(cal.returncode == 0, f"transport_calibration --smoke exited "
                               f"{cal.returncode}: {cal.stderr[-2000:]}")

    with tempfile.TemporaryDirectory() as tmp:
        trainer = _socket_trainer(torch, smi, tmp)
    emit("federation_socket_phase", seconds=time.perf_counter() - t_phase)
    return launches, trainer


def phase_vision(torch):
    import torch.nn.functional as F

    from repro_torch.core.federation import Federation, FederationConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.group_mean import batches
    from repro_torch.tree import tree_leaves, tree_map

    cfg = FederationConfig(n_peers=16, technique="mar", task="vision",
                           kernel_group_mean=True)
    fed = Federation(cfg)
    state = fed.init_state()
    ops.reset_launch_counts()
    for _ in range(3):
        state = fed.step(state)
    launches = ops.launch_counts()["group_mean"]
    with torch.no_grad():
        p0 = tree_map(lambda x: x[:1], state.params)
        logits = fed.apply_fn(p0, fed.test["x"].unsqueeze(0))[0]
        loss = float(F.cross_entropy(logits, fed.test["y"]))
    dis = fed.peer_disagreement(state)
    want = 3 * fed.plan.depth * len(batches(tree_leaves(
        {"p": state.params, "m": state.momentum})))
    emit("vision", n_peers=16, grid=list(fed.plan.dims), test_loss=loss,
         accuracy=fed.evaluate(state), disagreement=dis, launches=launches,
         expected_launches=want)
    check(math.isfinite(loss), f"vision loss {loss} is not finite")
    check(all(bool(torch.isfinite(x).all())
              for x in tree_leaves(state.params)), "vision params not finite")
    check(dis <= 1e-10, f"vision disagreement {dis} > 1e-10")
    check(want == 12, f"expected 12 vision launches, plan gives {want}")
    check(launches == want, f"vision launches {launches} != {want}")


def _run_extension(torch, cfg, ops, iterations: int = 20) -> dict:
    """``iterations`` steps of one config on the card: ms per step, the
    group-mean launches, the grid depth and fleet size of every step,
    accuracy at iteration 20, and every membership change the federation
    applied, with the state just before and just after it."""
    from repro_torch.core.federation import Federation

    fed = Federation(cfg)           # the default device: cuda
    changes = []
    apply = fed.apply_membership

    def spy(state, change):         # observe the membership entry point
        out = apply(state, change)
        changes.append((change, state, out))
        return out

    fed.apply_membership = spy
    state = fed.init_state()
    clip0 = float(state.dp["clip"]) if state.dp else None
    step_s, depths, sizes = [], [], []
    ops.reset_launch_counts()
    for _ in range(iterations):
        t0 = time.perf_counter()
        state = fed.step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        depths.append(fed.plan.depth)
        sizes.append(fed.cfg.n_peers)
    launches = ops.launch_counts()["group_mean"]
    return {"fed": fed, "state": state, "step_s": step_s, "depths": depths,
            "sizes": sizes, "launches": launches, "changes": changes,
            "accuracy": fed.evaluate(state), "clip0": clip0}


def _kernel_vs_plain_every_aggregation(torch, cfg, iterations: int = 20
                                       ) -> float:
    """One more run of ``cfg`` on the card in which every MAR
    aggregation is computed twice from the same input, by the kernel and
    by the kernel-off route; the run goes on with the kernel's
    result. Returns the largest difference over every leaf (DP's
    indicator and smoothed deltas included) of every aggregation."""
    from repro_torch.core import mar_allreduce as mar
    from repro_torch.core.federation import Federation
    from repro_torch.tree import tree_leaves

    worst = [0.0]
    route = mar.mar_aggregate_sim

    def both(state, plan, mask=None, num_rounds=None, use_kernel=False):
        out = route(state, plan, mask, num_rounds=num_rounds,
                    use_kernel=use_kernel)
        plain = route(state, plan, mask, num_rounds=num_rounds,
                      use_kernel=False)
        worst[0] = max([worst[0]] + [
            float((a.float() - b.float()).abs().max())
            for a, b in zip(tree_leaves(out), tree_leaves(plain))])
        return out

    mar.mar_aggregate_sim = both
    try:
        fed = Federation(cfg)
        state = fed.init_state()
        for _ in range(iterations):
            state = fed.step(state)
    finally:
        mar.mar_aggregate_sim = route
    return worst[0]


def phase_federation_extensions(torch, smi) -> int:
    """The quickstart under each protocol extension (quickstart.EXTENSIONS)
    on the card, kernel on, 20 iterations; returns the group-mean
    launches of these runs."""
    from repro_torch.core.compression import INT8_RATIO
    from repro_torch.kernels import ops
    from repro_torch.quickstart import EXTENSIONS, extension_config
    from repro_torch.tree import tree_leaves

    total = 0
    for name in EXTENSIONS:
        want_bytes, want_s, (acc_lo, acc_hi) = EXTENSION_REF[name]
        cfg = extension_config(name)
        r = _run_extension(torch, cfg, ops)
        fed, state = r["fed"], r["state"]
        # one launch per MAR round: every aggregated tree here (theta and
        # m, plus DP's smoothed deltas and indicator) is one f32 batch
        want_launches = sum(r["depths"])
        row = {"extension": name, "n_peers": r["sizes"],
               "grid_end": list(fed.plan.dims),
               "stages": list(fed.pipeline.stage_names),
               "comm_bytes": fed.comm_bytes, "sim_seconds": fed.sim_seconds,
               "by_source": fed.ledger.by_source,
               "launches": r["launches"], "expected_launches": want_launches,
               "accuracy_20": r["accuracy"], "accuracy_band": [acc_lo, acc_hi],
               "first_step_ms": r["step_s"][0] * 1e3,
               "ms_per_iteration": statistics.median(r["step_s"][1:]) * 1e3,
               "card": smi}
        if cfg.use_kd:          # the distilling steps after the first
            row["kd_step_ms"] = statistics.median(
                r["step_s"][1:cfg.kd_iterations]) * 1e3
        if state.dp:
            row.update(clip_start=r["clip0"], clip_end=float(state.dp["clip"]))
        check(want_launches == (67 if name == "elastic" else 60),
              f"{name}: the grids give {want_launches} rounds")
        check(r["launches"] == want_launches,
              f"{name}: group_mean launched {r['launches']} times, expected "
              f"{want_launches}")
        check(fed.comm_bytes == want_bytes,
              f"{name}: comm_bytes {fed.comm_bytes} != {want_bytes}")
        check(abs(fed.sim_seconds - want_s) <= 1e-9,
              f"{name}: sim_seconds {fed.sim_seconds} != {want_s}")
        check(all(bool(torch.isfinite(x).all())
                  for x in tree_leaves(state.params)),
              f"{name}: params not finite")
        check(acc_lo <= r["accuracy"] <= acc_hi,
              f"{name}: accuracy {r['accuracy']} at iteration 20 outside "
              f"[{acc_lo}, {acc_hi}]")
        if state.dp:
            check(row["clip_end"] != r["clip0"], f"{name}: the clip never "
                                                 f"moved")
        if name == "int8_ef":
            check(fed.comm_bytes == QUICKSTART_BYTES / INT8_RATIO,
                  f"int8_ef bytes {fed.comm_bytes} != a quarter of "
                  f"{QUICKSTART_BYTES}")
        if name == "elastic":
            row.update(_elastic_checks(torch, tree_leaves, r))
        off = _run_extension(torch, extension_config(
            name, kernel_group_mean=False), ops)
        diff = max(float((x - y).abs().max()) for x, y in zip(
            tree_leaves(state.params), tree_leaves(off["state"].params)))
        row.update(kernel_off_max_param_diff=diff,
                   kernel_off_launches=off["launches"],
                   kernel_off_ms_per_iteration=statistics.median(
                       off["step_s"][1:]) * 1e3)
        check(off["launches"] == 0, f"{name}: kernel-off run launched "
                                    f"{off['launches']}")
        if name in KERNEL_OFF_GATED:
            check(diff <= 1e-5, f"{name}: kernel on/off params differ "
                                f"by {diff} > 1e-5")
        shadow = _kernel_vs_plain_every_aggregation(torch, cfg)
        row["kernel_vs_kernel_off_every_aggregation_max_diff"] = shadow
        check(shadow <= 1e-5, f"{name}: the kernel's aggregation differs "
                              f"from the kernel-off route's by {shadow} > "
                              f"1e-5")
        emit("federation_extensions", **row)
        total += r["launches"]
    return total


def _run_large_n(torch, cfg, ops, iterations: int = 20) -> dict:
    """``iterations`` steps of one large-N config on the card: ms per
    step, and per step the group-mean launches and the depth of the grid
    in force (a regroup lands after its step)."""
    from repro_torch.core.federation import Federation

    fed = Federation(cfg)           # the default device: cuda
    state = fed.init_state()
    step_s, depths, per_step = [], [], []
    ops.reset_launch_counts()
    for _ in range(iterations):
        depths.append(fed.plan.depth)
        before = ops.launch_counts()["group_mean"]
        t0 = time.perf_counter()
        state = fed.step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append(ops.launch_counts()["group_mean"] - before)
    return {"fed": fed, "state": state, "step_s": step_s, "depths": depths,
            "per_step": per_step, "launches": sum(per_step),
            "accuracy": fed.evaluate(state)}


def phase_federation_large_n(torch, smi) -> int:
    """The large-N engines and controllers on the card (LARGE_N_RUNS, the
    group mean in the kernel, 20 iterations): adaptive group sizing at
    N = 125 (5 x 5 x 5) on the wireless profile under each transport,
    and clustered placement at N = 64 on shuffled regions. Each run's
    ledger by source, sim_seconds (within 1e-9), regroup_log and
    placement_log are the reference's (LARGE_N_REF); the three
    transports' ledgers equal each other; the adaptive runs regroup at
    least once, onto grids with virtual slots; every step launches the
    group mean once per round of the grid in force; accuracy at 20
    within the reference's band; and a second run of each, in which
    every aggregation is also computed by the kernel-off route from the
    same input, agrees within 1e-5. Returns the main runs' launches."""
    from repro_torch.core.federation import FederationConfig
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves

    total, ledgers = 0, {}
    for name, kw in LARGE_N_RUNS.items():
        ref = LARGE_N_REF[name]
        cfg = FederationConfig(kernel_group_mean=True, **kw)
        r = _run_large_n(torch, cfg, ops)
        fed, state = r["fed"], r["state"]
        by_source = dict(fed.ledger.by_source)
        regroups = [[t, list(a), list(b)] for t, a, b in fed.regroup_log]
        placements = [list(x) for x in fed.placement_log]
        row = {"run": name, "n_peers": cfg.n_peers,
               "transport": cfg.transport, "grid_end": list(fed.plan.dims),
               "comm_bytes": fed.comm_bytes, "sim_seconds": fed.sim_seconds,
               "by_source": by_source, "regroup_log": regroups,
               "placement_log": placements, "depths": r["depths"],
               "launches_per_step": r["per_step"],
               "launches": r["launches"], "accuracy_20": r["accuracy"],
               "accuracy_band": ref["band"],
               "first_step_ms": r["step_s"][0] * 1e3,
               "ms_per_iteration": statistics.median(r["step_s"][1:]) * 1e3,
               "card": smi}
        check(by_source == ref["by_source"]
              and fed.comm_bytes == ref["comm_bytes"],
              f"{name}: ledger {by_source} != the reference's "
              f"{ref['by_source']}")
        check(abs(fed.sim_seconds - ref["sim_seconds"]) <= 1e-9,
              f"{name}: sim_seconds {fed.sim_seconds} != "
              f"{ref['sim_seconds']}")
        check(regroups == ref["regroup_log"],
              f"{name}: regroups {regroups} != {ref['regroup_log']}")
        check(placements == ref["placement_log"],
              f"{name}: placements {placements} != {ref['placement_log']}")
        if cfg.adaptive_m:
            check(regroups, f"{name}: no regroup")
            ledgers[name] = (by_source, fed.sim_seconds, regroups)
        else:
            check(placements and by_source.get("placement_probe", 0) > 0,
                  f"{name}: no placement regroup or no probe traffic")
        check(r["per_step"] == r["depths"],
              f"{name}: group_mean launches per step {r['per_step']} != "
              f"the rounds of the grid in force {r['depths']}")
        check(all(bool(torch.isfinite(x).all())
                  for x in tree_leaves(state.params)),
              f"{name}: params not finite")
        lo, hi = ref["band"]
        check(lo <= r["accuracy"] <= hi,
              f"{name}: accuracy {r['accuracy']} at iteration 20 outside "
              f"[{lo}, {hi}]")
        shadow = _kernel_vs_plain_every_aggregation(torch, cfg)
        row["kernel_vs_kernel_off_every_aggregation_max_diff"] = shadow
        check(shadow <= 1e-5, f"{name}: the kernel's aggregation differs "
                              f"from the kernel-off route's by {shadow}")
        emit("federation_large_n", **row)
        total += r["launches"]
    check(len({json.dumps(v, sort_keys=True) for v in ledgers.values()})
          == 1, f"federation_large_n: the transports' ledgers differ: "
                f"{ledgers}")
    return total


def _elastic_checks(torch, tree_leaves, r) -> dict:
    """The elastic run: 27 peers, 13 from iteration 7, 26 from 14;
    survivors bit-exact across each change, joiners at the f32 mean."""
    sizes = r["sizes"]
    check(sizes == [27] * 7 + [13] * 7 + [26] * 6,
          f"elastic: n_peers per step {sizes}")
    check(len(r["changes"]) == 2, f"elastic: {len(r['changes'])} changes")
    out = []
    for change, before, after in r["changes"]:
        k = len(change.survivors)
        joiner_err = 0.0
        for old, new in ((before.params, after.params),
                         (before.momentum, after.momentum)):
            for x, y in zip(tree_leaves(old), tree_leaves(new)):
                check(torch.equal(y[:k], x[:k]),
                      f"elastic: survivors changed at {change.old_n} -> "
                      f"{change.new_n}")
                if change.new_n > k:
                    mean = x.double().mean(0, keepdim=True)
                    joiner_err = max(joiner_err, float(
                        (y[k:].double() - mean).abs().max()))
        check(joiner_err <= 1e-6, f"elastic: joiners {joiner_err} from the "
                                  f"f32 mean")
        out.append({"old_n": change.old_n, "new_n": change.new_n,
                    "grid": list(change.new_plan.dims),
                    "survivors_bit_exact": True,
                    "joiner_max_err_vs_mean": joiner_err})
    # the steps that began with a change: 7 and 14
    return {"membership_changes": out,
            "resize_step_ms": [r["step_s"][t] * 1e3 for t in (7, 14)]}


def _rerun_diff(torch, cfg, steps: int) -> float:
    """Two runs of one config from one seed on the card: the largest
    difference of their params after ``steps`` steps (0: exact from
    run to run)."""
    from repro_torch.core.federation import Federation
    from repro_torch.tree import tree_leaves

    runs = []
    for _ in range(2):
        fed = Federation(cfg)
        state = fed.init_state()
        for _ in range(steps):
            state = fed.step(state)
        runs.append(tree_leaves(state.params))
    return max(float((a - b).abs().max()) for a, b in zip(*runs))


def phase_figures(torch, smi) -> int:
    """``repro_torch.figures --smoke`` on the card, every MAR round's
    group mean in the kernel: every row's comm_mb and sim_s equal the
    reference's (FIGURE_ROWS), and Fig. 5's divergence within 1e-5;
    Figs. 8 and 11 as ``figure_ext_mismatches`` holds them
    (FIGURE_EXT_ROWS: partition statistics and comm_mb equal, accuracy
    in its band). Then Fig. 5's MAR (kernel on and off) and FedAvg configs at N=125
    twice each: every route must be exact from run to run. Returns the
    kernel's launches in the figure runs."""
    import contextlib
    import io

    from repro_torch.core.federation import FederationConfig
    from repro_torch.figures import run_figures, scale
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = run_figures(["1", "2", "3", "4", "5", "8", "11"],
                           scale(False, True), 0, None, smoke=True)
    launches = ops.launch_counts()["group_mean"]
    seconds = time.perf_counter() - t0
    ext = {name for name, _ in FIGURE_EXT_ROWS}
    got = [r for r in rows if r["row"] not in ("fig1_scaling", "fig_timing")
           and r["row"] not in ext]
    bad = figure_ext_mismatches(rows)
    check(not bad, f"figures: Figs. 8 and 11 part from the reference: "
                   f"{bad}")
    check(len(got) == len(FIGURE_ROWS),
          f"figures: {len(got)} rows, the reference prints "
          f"{len(FIGURE_ROWS)}")
    for r, (name, comm_mb, sim_s) in zip(got, FIGURE_ROWS):
        check(r["row"] == name, f"figures: row {r['row']} where the "
                                f"reference has {name}")
        for key, want in (("comm_mb", comm_mb), ("sim_s", sim_s)):
            check(want is None or str(r.get(key)) == want,
                  f"figures: {name} {key} {r.get(key)} != {want}")
        if name == "fig5_divergence":
            check(float(r["max_param_diff"]) <= 1e-5,
                  f"figures: Fig. 5 {r['technique']} diverges from FedAvg "
                  f"by {r['max_param_diff']} > 1e-5")
    check(launches > 0, "figures: the group-mean kernel never launched")
    timing = [r for r in rows if r["row"] == "fig_timing"]

    full = scale(True)
    base = dict(n_peers=full["peers"], task="text",
                local_batches=full["local_batches"], seed=0)
    rerun = {label: _rerun_diff(torch, FederationConfig(**base, **kw), 10)
             for label, kw in (
                 ("mar_kernel", dict(technique="mar",
                                     kernel_group_mean=True)),
                 ("mar_kernel_off", dict(technique="mar")),
                 ("fedavg", dict(technique="fedavg")))}
    emit("figures", seconds=seconds, rows=got,
         ext_rows=[r for r in rows if r["row"] in ext], launches=launches,
         ms_per_iteration={f"{r['fig']}/{r['run']}": r["ms_per_iteration"]
                           for r in timing},
         rerun_max_param_diff_n125_10_steps=rerun, card=smi)
    check(all(v == 0.0 for v in rerun.values()),
          f"figures: a route differs between two runs of one config: "
          f"{rerun}")
    return launches


def profile_quickstart(torch, steps: int = 10, cfg=None) -> dict:
    """Where a kernel-on quickstart step's time goes.

    ``steps`` ``Federation.step`` calls under ``torch.profiler``, after
    three unprofiled ones, of ``cfg`` (the quickstart by default). The
    step's own labels (transport, local update, aggregation, and MKD
    where the port has it and the config distills) give each layer's
    host time, its kernel launches (the runtime's launch calls
    inside the label) and the device time of the work those calls and
    its copies queued (matched to the device events by correlation id,
    so kernels launched through ctypes count too); the kernels give the
    device's busy share of the wall time and the launches per step. The
    profiler slows the host, so these times are shares, not the step's
    speed (that is :func:`run_quickstart`'s). ``label_us`` is what one
    label costs with no profiler running, as every plain step pays it.
    Uses only what every version of the port has, so it can profile
    another checkout's package too.
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import federation
    from repro_torch.core.federation import (SPAN_AGGREGATE,
                                             SPAN_LOCAL_UPDATE,
                                             SPAN_TRANSPORT, Federation)
    from repro_torch.quickstart import quickstart_config

    if cfg is None:
        cfg = quickstart_config(kernel_group_mean=True)
    fed = Federation(cfg)
    state = fed.init_state()
    for _ in range(3):
        state = fed.step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state = fed.step(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    cpu = torch.autograd.DeviceType.CPU
    cuda = torch.autograd.DeviceType.CUDA
    names = {SPAN_TRANSPORT: "transport", SPAN_LOCAL_UPDATE: "local_update",
             SPAN_AGGREGATE: "aggregate"}
    # the steps that run each label: MKD only in the first kd_iterations
    counts = dict.fromkeys(names.values(), steps)
    span_mkd = getattr(federation, "SPAN_MKD", None)
    if span_mkd is not None and getattr(cfg, "use_kd", False):
        names[span_mkd] = "mkd"
        counts["mkd"] = sum(t < cfg.kd_iterations
                            for t in range(3, 3 + steps))
    spans = {v: {"host_ms": 0.0, "device_ms": 0.0, "launches": 0.0,
                 "count": 0} for v in names.values()}
    kernels: dict = {}
    ranges, runtime, device = [], [], []
    for e in prof.events():
        if e.name in names:         # the labels, on the CPU and the GPU
            if e.device_type == cpu:
                s = spans[names[e.name]]
                s["host_ms"] += e.time_range.elapsed_us() / steps / 1e3
                s["count"] += 1
                ranges.append((e.time_range.start, e.time_range.end, s))
        elif e.device_type == cuda:
            k = kernels.setdefault(e.name[:60], [0, 0.0])
            k[0] += 1
            k[1] += e.self_device_time_total
            device.append(e)
        elif any(w in e.name for w in ("LaunchKernel", "Memcpy", "Memset")):
            runtime.append(e)
    issued = {}                 # correlation id -> the label that issued it
    for e in runtime:
        t = e.time_range.start
        for a, b, s in ranges:
            if a <= t <= b:
                issued[e.id] = s
                s["launches"] += ("LaunchKernel" in e.name) / steps
                break
    for e in device:
        if e.id in issued:
            us = e.self_device_time_total
            issued[e.id]["device_ms"] += us / steps / 1e3
    for v, s in spans.items():
        check(s["count"] == counts[v], f"profile: label {v} seen "
                                       f"{s['count']} times in {steps} "
                                       f"steps, expected {counts[v]}")
    busy_us = sum(us for _, us in kernels.values())
    check(busy_us > 0, "profile: no device time recorded")

    n = 10_000
    t0 = time.perf_counter()
    for _ in range(n):
        with record_function(SPAN_TRANSPORT):
            pass
    label_us = (time.perf_counter() - t0) / n * 1e6

    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:5]
    return {"steps": steps, "label_counts": counts,
            "wall_ms_per_step": wall_us / steps / 1e3,
            "spans_per_step": {v: {"host_ms": s["host_ms"],
                                   "device_ms": s["device_ms"],
                                   "launches": s["launches"]}
                               for v, s in spans.items()},
            "device_launches_per_step":
                sum(c for c, _ in kernels.values()) / steps,
            "device_busy_ms_per_step": busy_us / steps / 1e3,
            "device_busy_share": busy_us / wall_us,
            "labelled_share_of_busy": sum(s["device_ms"] for s in
                                          spans.values()) * steps * 1e3
                                      / busy_us,
            "label_us": label_us,
            "top_kernels_per_step": [{"name": k, "launches": c / steps,
                                      "device_us": us / steps}
                                     for k, (c, us) in top]}


def phase_profile(torch):
    from repro_torch.quickstart import extension_config

    emit("profile", config="quickstart", **profile_quickstart(torch))
    for name in ("dp_secagg", "mkd"):
        emit("profile", config=name,
             **profile_quickstart(torch, cfg=extension_config(name)))


# ---------------------------------------------------------------------------
# serving: the attention kernels, the engine at full width, parity
# ---------------------------------------------------------------------------

STARCODER = dict(h=24, kvh=2, d=128)            # starcoder2-3b attention
ZAMBA2_ATTN = dict(h=32, kvh=32, d=80)          # zamba2-2.7b shared block
MOONSHOT_ATTN = dict(h=16, kvh=16, d=128)       # moonshot-v1-16b-a3b (g=1)
TRAIN_ATTN = dict(h=24, kvh=24, d=64)           # musicgen-medium (g=1)
#: the published Zamba2-2.7B's shared attention (models/zamba2.py):
#: 32 heads of 160, scaled by (160 / 2) ** -0.5, at 4,096 tokens
ZAMBA2_PUBLISHED_ATTN = dict(h=32, kvh=32, d=160)
ZAMBA2_PUBLISHED_SCALE = (160 / 2) ** -0.5
SERVE = dict(max_batch=8, block_size=16, pad_len=512, max_new=64,
             sessions=16)
SERVE_LAYERS = 30


def attention_bound_ms(nbytes: int, flops: int, bf16: bool) -> dict:
    """Least time for an attention call, the larger of two: its inputs
    read once and outputs written once over HBM (``bytes_ms``); the
    flops these inputs need over the peak rate of their type, the bf16
    tensor cores or the f32 cores (``ops_ms``)."""
    rate = BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S
    return {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": flops / rate * 1e3}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def shares(kernel_ms, bound_ms, library_ms) -> dict:
    """``bound_share``: the bound over the kernel's time (1 at the
    bound); ``vs_library``: the kernel's time over the library call's
    (null where there is none, or the kernel was not timed)."""
    return {"bound_share": bound_ms / kernel_ms if kernel_ms else None,
            "vs_library": (kernel_ms / library_ms
                           if kernel_ms and library_ms else None)}


def _row(kind, dtype, err, tol, kernel_ms, plain_ms, library_ms, bound,
         **shape):
    bound_ms = max(bound.values())
    return {"kind": kind, **shape,
            "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
            "tol": tol, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, **bound,
            **shares(kernel_ms, bound_ms, library_ms)}


def _tol(torch, dtype) -> float:
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def phase_flash(torch, flush):
    """The flash kernel against ``flash_attention_ref`` (o and lse); SDPA
    with ``is_causal`` and ``enable_gqa`` as the library yardstick."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    sc, za = STARCODER, ZAMBA2_ATTN
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for kind, s, dtype, heads in [
            ("path", SERVE["pad_len"], torch.bfloat16, sc),
            ("path", SERVE["pad_len"], torch.float32, sc),
            ("ragged", 24, torch.bfloat16, sc),
            ("ragged", 24, torch.float32, sc),
            ("ragged", 1000, torch.bfloat16, sc),
            ("ragged", 1000, torch.float32, sc),
            ("zamba2", RECURRENT["pad_len"], torch.bfloat16, za),
            ("tile_edge", 65, torch.bfloat16, sc),
            ("tile_edge", 129, torch.bfloat16, sc),
            ("zamba2_ragged", 200, torch.bfloat16, za),
            ("moonshot", SERVE["pad_len"], torch.bfloat16, MOONSHOT_ATTN),
            ("moonshot", SERVE["pad_len"], torch.float32, MOONSHOT_ATTN)]:
        h, kvh, d = heads["h"], heads["kvh"], heads["d"]
        q = torch.randn((1, s, h, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((1, s, kvh, d), generator=gen,
                        device="cuda").to(dtype)
        v = torch.randn((1, s, kvh, d), generator=gen,
                        device="cuda").to(dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        o_ref, lse_ref = flash_attention_ref(q, k, v, True)
        torch.cuda.synchronize()
        tol = _tol(torch, dtype)
        err = float((o.float() - o_ref.float()).abs().max())
        lse_err = float((lse - lse_ref).abs().max())
        check(o.dtype == dtype and o.shape == q.shape
              and lse.shape == (1, h, s), f"flash s={s}: bad outputs")
        check(err <= tol and lse_err <= tol,
              f"flash s={s} {dtype}: o err {err}, lse err {lse_err} > {tol}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pairs = s * (s + 1) // 2                   # causal (i, j), j <= i
        bound = attention_bound_ms(_nbytes(q, k, v, o, lse),
                                   4 * h * d * pairs,
                                   dtype == torch.bfloat16)
        row = _row(kind, dtype, err, tol,
                   device_ms(torch, lambda: fa.flash_attention_fwd(
                       q, k, v, True), flush=flush),
                   device_ms(torch, lambda: flash_attention_ref(
                       q, k, v, True), flush=flush),
                   device_ms(torch, lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True),
                       flush=flush),
                   bound, b=1, s=s, h=h, kvh=kvh, d=d)
        row["lse_max_abs_err"] = lse_err
        rows.append(row)
        emit("flash_attention", **row)
    rows.append(_flash_train_row(torch, flush, gen, "2t", TRAIN_ATTN))
    rows.append(_flash_train_row(torch, flush, gen, "2h", ZAMBA2_ATTN))
    rows.append(_flash_train_row(torch, flush, gen, "2p",
                                 ZAMBA2_PUBLISHED_ATTN, b=1,
                                 s=ZAMBA2_PUBLISHED["seq"],
                                 scale=ZAMBA2_PUBLISHED_SCALE))
    return rows


def _flash_train_row(torch, flush, gen, tag: str, attn: dict, b: int = 2,
                     s: int = 128, scale=None):
    """A row at a trainer's shape (2t, musicgen-medium: b=2, s=128,
    h=kvh=24, d=64; 2h, zamba2's shared block: h=kvh=32, d=80; 2p, the
    published Zamba2's: b=1, s=4,096, h=kvh=32, d=160 at its scale, the
    template's d = 160 instance; bf16), gated as the other rows, the
    kernel, the plain route and SDPA at the same ``scale`` (1/sqrt(d)
    where it is None); beside it, for information, the plain backward
    (``attention_flash.flash_bwd``, the reference's blockwise recompute)
    against SDPA's backward on the same inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models.attention_flash import flash_bwd

    dtype = torch.bfloat16
    h, kvh, d = attn["h"], attn["kvh"], attn["d"]
    q, k, v = (torch.randn((b, s, n, d), generator=gen,
                           device="cuda").to(dtype) for n in (h, kvh, kvh))
    do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    o_ref, lse_ref = flash_attention_ref(q, k, v, True, scale)
    torch.cuda.synchronize()
    tol = _tol(torch, dtype)
    err = float((o.float() - o_ref.float()).abs().max())
    lse_err = float((lse - lse_ref).abs().max())
    check(err <= tol and lse_err <= tol,
          f"flash {tag}: o err {err}, lse err {lse_err} > {tol}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = s * (s + 1) // 2
    bound = attention_bound_ms(_nbytes(q, k, v, o, lse),
                               4 * b * h * d * pairs, True)
    row = _row("train", dtype, err, tol,
               device_ms(torch, lambda: fa.flash_attention_fwd(
                   q, k, v, True, scale), flush=flush),
               device_ms(torch, lambda: flash_attention_ref(
                   q, k, v, True, scale), flush=flush),
               device_ms(torch, lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, scale=scale), flush=flush),
               bound, b=b, s=s, h=h, kvh=kvh, d=d)
    row.update(lse_max_abs_err=lse_err, row=tag, scale=scale)
    lse4 = lse.view(b, kvh, h // kvh, s)
    row["plain_backward_ms"] = device_ms(
        torch, lambda: flash_bwd(q, k, v, o, lse4, do, True, scale=scale),
        flush=flush)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                         scale=scale)
    dot = do.transpose(1, 2)
    row["sdpa_backward_ms"] = device_ms(
        torch, lambda: torch.autograd.grad(out, (qg, kg, vg), dot,
                                           retain_graph=True),
        flush=flush)
    emit("flash_attention", **row)
    return row


def _decode_bytes_flops(q, cache_row_bytes, lengths_host, h, d):
    """Bytes (q read, out written, the K and V rows of every filled
    position read once) and flops (4 per filled position, head and head
    dim) of one decode attention call."""
    filled = int(sum(lengths_host))
    return (2 * q.numel() * q.element_size() + filled * cache_row_bytes,
            4 * h * d * filled)


def phase_paged(torch, flush):
    """The paged kernel against ``gather_dense_decode`` at the serving
    path's decode shapes (b=8, pages of 16, 36 table columns, 289 pages):
    lengths 1, full, mid-page and others, and one row whose table is all
    scratch page 0 (length 1), as an inactive engine row; starcoder2's
    heads (g=12) and moonshot's (g=1)."""
    from repro_torch.kernels import paged_attention as pa

    b, bs = SERVE["max_batch"], SERVE["block_size"]
    nblk = -(-(SERVE["pad_len"] + SERVE["max_new"]) // bs)          # 36
    nb = 1 + nblk * b                                                 # 289
    lengths_host = [1, nblk * bs, 13 * bs + 7, bs, 300, 450, 17, 1]
    gen = torch.Generator(device="cuda").manual_seed(2)
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tables = perm[:b * nblk].reshape(b, nblk).to(torch.int32)
    tables[-1] = 0                                 # the scratch-only row
    lengths = torch.tensor(lengths_host, dtype=torch.int32, device="cuda")
    rows = []
    for kind, heads, dtype in [("path", STARCODER, torch.bfloat16),
                               ("path", STARCODER, torch.float32),
                               ("moonshot", MOONSHOT_ATTN, torch.bfloat16),
                               ("moonshot", MOONSHOT_ATTN, torch.float32)]:
        h, kvh, d = heads["h"], heads["kvh"], heads["d"]
        q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
        kp = torch.randn((nb, bs, kvh, d), generator=gen,
                         device="cuda").to(dtype)
        vp = torch.randn((nb, bs, kvh, d), generator=gen,
                         device="cuda").to(dtype)
        out = pa.paged_decode_attention_fwd(q, kp, vp, tables, lengths)
        want = pa.gather_dense_decode(q, kp, vp, tables, lengths)
        torch.cuda.synchronize()
        tol = _tol(torch, dtype)
        err = float((out.float() - want.float()).abs().max())
        check(bool(torch.isfinite(out).all()), "paged: non-finite output")
        check(err <= tol, f"paged {kind} {dtype}: max abs err {err} > {tol}")
        nbytes, flops = _decode_bytes_flops(
            q, 2 * kvh * d * q.element_size(), lengths_host, h, d)
        nbytes += _nbytes(tables, lengths)
        bound = attention_bound_ms(nbytes, flops, dtype == torch.bfloat16)
        row = _row(kind, dtype, err, tol,
                   device_ms(torch, lambda: pa.paged_decode_attention_fwd(
                       q, kp, vp, tables, lengths), flush=flush),
                   device_ms(torch, lambda: pa.gather_dense_decode(
                       q, kp, vp, tables, lengths), flush=flush),
                   None, bound, b=b, h=h, kvh=kvh, d=d, bs=bs, nblk=nblk,
                   num_blocks=nb, lengths=lengths_host)
        rows.append(row)
        emit("paged_decode", **row)
    return rows


def phase_decode(torch, flush):
    """The dense decode kernel against ``decode_attention_ref`` on a
    cache of S=1000 (not a multiple of the tile), at the split edges: a
    cache of S=1, and rows of length 0 (which get zeros); SDPA with a
    boolean length mask as the library yardstick."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.ref import decode_attention_ref

    h, kvh, d = STARCODER["h"], STARCODER["kvh"], STARCODER["d"]
    b = SERVE["max_batch"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for kind, s, dtype, lengths_host in [
            ("S1000", 1000, torch.bfloat16, [1, 1000, 999, 500, 33, 640, 17,
                                             250]),
            ("S1000", 1000, torch.float32, [1, 1000, 999, 500, 33, 640, 17,
                                            250]),
            ("S1", 1, torch.bfloat16, [1, 0, 1, 1, 0, 1, 1, 1]),
            ("len0", 1000, torch.bfloat16, [0, 1000, 0, 999, 33, 640, 0,
                                            250])]:
        lengths = torch.tensor(lengths_host, dtype=torch.int32,
                               device="cuda")
        mask = (torch.arange(s, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]      # [b, 1, 1, S]
        q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
        kc = torch.randn((b, s, kvh, d), generator=gen,
                         device="cuda").to(dtype)
        vc = torch.randn((b, s, kvh, d), generator=gen,
                         device="cuda").to(dtype)
        out = da.decode_attention_fwd(q, kc, vc, lengths)
        want = decode_attention_ref(q, kc, vc, lengths)
        torch.cuda.synchronize()
        tol = _tol(torch, dtype)
        # a row of length 0 gets zeros, as the TPU kernel gives; the plain
        # version's softmax over all-masked scores averages v instead
        filled = [i for i, n in enumerate(lengths_host) if n > 0]
        empty = [i for i, n in enumerate(lengths_host) if n == 0]
        err = float((out[filled].float() - want[filled].float()).abs().max())
        check(bool(torch.isfinite(out).all()),
              f"decode {kind} {dtype}: non-finite output")
        check(err <= tol, f"decode {kind} {dtype}: max abs err {err} > {tol}")
        check(not empty or not bool(out[empty].any()),
              f"decode {kind}: a row of length 0 is not all zeros")
        nbytes, flops = _decode_bytes_flops(
            q, 2 * kvh * d * q.element_size(), lengths_host, h, d)
        nbytes += _nbytes(lengths)
        bound = attention_bound_ms(nbytes, flops, dtype == torch.bfloat16)
        q4, kt, vt = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
        row = _row(kind, dtype, err, tol,
                   device_ms(torch, lambda: da.decode_attention_fwd(
                       q, kc, vc, lengths), flush=flush),
                   device_ms(torch, lambda: decode_attention_ref(
                       q, kc, vc, lengths), flush=flush),
                   device_ms(torch, lambda: F.scaled_dot_product_attention(
                       q4, kt, vt, attn_mask=mask, enable_gqa=True),
                       flush=flush),
                   bound, b=b, S=s, h=h, kvh=kvh, d=d, lengths=lengths_host)
        rows.append(row)
        emit("decode_attention", **row)
    return rows


def _serve_prompts(vocab: int, n: int, max_len: int):
    """Prompt lengths and tokens as ``launch/serve.py --vary-prompts``
    draws them from ``default_rng(0)``."""
    import numpy as np

    rng = np.random.default_rng(0)
    plens = rng.integers(1, max_len + 1, n)
    return [rng.integers(0, vocab, k).tolist() for k in plens]


def _serve_config(ServeConfig, max_new: int = SERVE["max_new"]):
    """The engine geometry, with ``launch/serve.py``'s pool size: a full
    batch's worst case plus the scratch page."""
    bs, pad = SERVE["block_size"], SERVE["pad_len"]
    need = -(-(pad + max_new) // bs)
    return ServeConfig(max_batch=SERVE["max_batch"], block_size=bs,
                       num_blocks=1 + need * SERVE["max_batch"],
                       pad_len=pad, max_new=max_new)


def _prompt_tokens(torch, prompt):
    import numpy as np

    toks = np.zeros((1, SERVE["pad_len"]), np.int32)
    toks[0, :len(prompt)] = prompt
    return torch.as_tensor(toks).cuda()


def phase_serve(torch, smi):
    """starcoder2-3b at full width through the port's engine."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serve import DecodeServer, ServeConfig

    cfg = get_config("starcoder2-3b")
    check(cfg.num_layers == SERVE_LAYERS and cfg.dtype == "bfloat16"
          and cfg.attn_impl == "flash", f"unexpected config {cfg}")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0)             # the default device: cuda
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    scfg = _serve_config(ServeConfig)
    check(scfg.num_blocks == 289, f"num_blocks {scfg.num_blocks} != 289")
    prompts = _serve_prompts(cfg.vocab_size, SERVE["sessions"],
                             SERVE["pad_len"])

    warm = DecodeServer(model, params, _serve_config(ServeConfig, 2))
    warm.enqueue(prompts[0])
    warm.run()
    del warm

    srv = DecodeServer(model, params, scfg)
    for p in prompts:
        srv.enqueue(p)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = ops.launch_counts()
    srv.assert_quiescent()
    st = srv.stats()
    peak = torch.cuda.max_memory_allocated()

    with torch.inference_mode():
        logits, _, _ = model.forward(params, _prompt_tokens(torch,
                                                            prompts[0]))
        finite = bool(torch.isfinite(logits).all())
    out = {"arch": cfg.name, "params": cfg.param_count(),
           "init_s": init_s, "sessions": len(srv.finished),
           "prefills": st["prefills"], "decode_steps": st["decode_steps"],
           "tokens": st["tokens"], "elapsed_s": elapsed,
           "tokens_per_s": st["tokens"] / elapsed,
           "ttft_p50_ms": st["p50_ttft_s"] * 1e3,
           "per_token_p50_ms": st["p50_tok_s"] * 1e3,
           "per_token_p99_ms": st["p99_tok_s"] * 1e3,
           "peak_memory_bytes": peak, "launches": launches,
           "logits_finite": finite, "card": smi}
    emit("serve", **out)
    check(len(srv.finished) == SERVE["sessions"]
          and all(len(s.generated) == SERVE["max_new"]
                  for s in srv.finished),
          "serve: a session did not finish with 64 tokens")
    check(finite, "serve: prefill logits are not finite")
    check(launches["flash_attention"] == st["prefills"] * SERVE_LAYERS,
          f"flash launched {launches['flash_attention']} times for "
          f"{st['prefills']} prefills of {SERVE_LAYERS} layers")
    check(launches["paged_decode_attention"]
          == st["decode_steps"] * SERVE_LAYERS,
          f"paged kernel launched {launches['paged_decode_attention']} "
          f"times for {st['decode_steps']} decode steps")

    # ten decode steps of a full batch under the profiler
    prof_srv = DecodeServer(model, params, scfg)
    for p in prompts[:SERVE["max_batch"]]:
        prof_srv.enqueue(p)
    prof_srv.step()                       # admits all eight, one decode
    torch.cuda.synchronize()
    steps = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            prof_srv.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    emit("serve_profile", steps=steps, batch=len(prof_srv.running),
         **_device_profile(torch, prof, wall_us, steps, "serve profile"))

    # one full-width prefill (pad 512) under the profiler
    toks = _prompt_tokens(torch, prompts[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.inference_mode():
            model.forward(params, toks)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    emit("serve_prefill_profile", pad_len=SERVE["pad_len"],
         **_device_profile(torch, prof, wall_us, 1, "serve prefill profile"))
    return launches


#: name stems of the port's own kernels in a profiler trace
PORT_KERNELS = ("flash_fwd_", "decode_split_", "ssd_scan_", "ssd_bwd_",
                "group_mean_")


def _device_profile(torch, prof, wall_us: float, steps: int,
                    what: str, labels=()) -> dict:
    """Per step: wall and device-busy time, the busy share, kernel
    launches, the eight kernels with the most device time, and the
    port's own kernels with their share of the busy time. ``labels``
    are ``record_function`` names, whose device-side ranges are not
    kernels."""
    kernels: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.name not in labels:
            k = kernels.setdefault(e.name[:60], [0, 0.0])
            k[0] += 1
            k[1] += e.self_device_time_total
    busy_us = sum(us for _, us in kernels.values())
    check(busy_us > 0, f"{what}: no device time recorded")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    port = {}
    for name, (c, us) in kernels.items():
        for k in PORT_KERNELS:
            if k in name:
                p = port.setdefault(k, {"launches": 0.0, "device_us": 0.0})
                p["launches"] += c / steps
                p["device_us"] += us / steps
    for p in port.values():
        p["share_of_busy"] = p["device_us"] / (busy_us / steps)
    return {"wall_ms_per_step": wall_us / steps / 1e3,
            "port_kernels_per_step": port,
            "device_busy_ms_per_step": busy_us / steps / 1e3,
            "device_busy_share": busy_us / wall_us,
            "kernel_launches_per_step":
                sum(c for c, _ in kernels.values()) / steps,
            "top_kernels_per_step": [{"name": k, "launches": c / steps,
                                      "device_us": us / steps}
                                     for k, (c, us) in top]}


def phase_serve_parity(torch):
    """starcoder2-3b's widths at 2 layers in f32: the engine (paged
    kernel) against the sequential baseline (plain dense decode), and
    the flash kernel's prefill logits against the plain path's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve import DecodeServer, ServeConfig, run_sequential

    cfg = dataclasses.replace(get_config("starcoder2-3b"), num_layers=2,
                              dtype="float32")
    model = Model(cfg)
    params = model.init(seed=0)
    prompts = _serve_prompts(cfg.vocab_size, 12, SERVE["pad_len"])
    srv = DecodeServer(model, params, _serve_config(ServeConfig))
    for p in prompts:
        srv.enqueue(p)
    srv.run()
    srv.assert_quiescent()
    seq = run_sequential(model, params, prompts, max_new=SERVE["max_new"],
                         pad_len=SERVE["pad_len"])
    eng = {s.sid: s.generated for s in srv.finished}
    same = [eng[s.sid] == s.generated for s in seq]

    with torch.inference_mode():
        toks = _prompt_tokens(torch, prompts[0])
        flash, _, _ = model.forward(params, toks)
        plain, _, _ = Model(dataclasses.replace(cfg, attn_impl="xla")) \
            .forward(params, toks)
        logit_err = float((flash - plain).abs().max())
    emit("serve_parity", layers=2, dtype="float32", sessions=len(prompts),
         streams_equal=sum(same), engine_decode_steps=srv.decode_steps,
         prefill_logits_flash_vs_xla_max_abs_err=logit_err)
    check(all(same), f"serve_parity: {len(same) - sum(same)} of "
                     f"{len(same)} engine streams differ from sequential")
    check(logit_err <= 1e-4, f"serve_parity: flash vs xla prefill logits "
                             f"differ by {logit_err} > 1e-4")


# ---------------------------------------------------------------------------
# recurrent serving: the SSD-scan kernel, zamba2 and xlstm at full width
# ---------------------------------------------------------------------------

RECURRENT = dict(pad_len=512, max_new=32, sessions=4)
#: per prefill: (ssd_scan launches, flash launches) of the published models
RECURRENT_LAUNCHES = {"zamba2-2.7b": (45, 9), "xlstm-350m": (21, 0)}
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def ssd_flops(b: int, nh: int, s: int, dk: int, dv: int) -> int:
    """The reference's operations for one call: its chunk (256, halved
    until it divides S) and per chunk q k^T, the gated product with v,
    q . H and the state update, two flops per multiply-add."""
    c = min(256, s)
    while s % c:
        c //= 2
    return b * nh * (s // c) * 2 * (c * c * dk + c * c * dv + 2 * c * dk * dv)


def _ssd_inputs(torch, gen, arch, s, dtype, h0_scale, b=1):
    """Inputs shaped and scaled as the two families' prefill makes them.
    zamba2: B and C one [S, 64] draw broadcast over 80 heads (head stride
    0), v = x * dt, log_a = dt * A with A = -(1..80) per head and dt =
    softplus(N(0, 1)), so a reaches about -55 a step at the last heads.
    xlstm: q / sqrt(512), v with mLSTM's ones column (dv 513) times a
    sigmoid input gate, log_a = logsigmoid(N(0, 1))."""
    import torch.nn.functional as F

    dev = dict(device="cuda")
    if arch == "zamba2":
        nh, dk, dv = 80, 64, 64
        bc = torch.randn((2, b, 1, s, dk), generator=gen, **dev).to(dtype)
        q, k = (x.expand(b, nh, s, dk) for x in bc)
        dt = F.softplus(torch.randn((b, nh, s), generator=gen, **dev))
        a = -torch.arange(1, nh + 1, dtype=torch.float32, **dev)
        log_a = dt * a[None, :, None]
        v = (torch.randn((b, nh, s, dv), generator=gen, **dev)
             * dt[..., None]).to(dtype)
    else:
        nh, dk, dv = 4, 512, 513
        q = (torch.randn((b, nh, s, dk), generator=gen, **dev)
             / math.sqrt(dk)).to(dtype)
        k = torch.randn((b, nh, s, dk), generator=gen, **dev).to(dtype)
        v = torch.cat([torch.randn((b, nh, s, dk), generator=gen, **dev),
                       torch.ones((b, nh, s, 1), **dev)], dim=-1)
        gate = torch.sigmoid(torch.randn((b, nh, s), generator=gen, **dev))
        v = (v * gate[..., None]).to(dtype)
        log_a = F.logsigmoid(torch.randn((b, nh, s), generator=gen, **dev))
    h0 = torch.randn((b, nh, dk, dv), generator=gen, **dev) * h0_scale
    return q, k, v, log_a, h0


def _relayout(torch, arch, v, h0):
    """The bf16 kernel's other two v layouts: zamba2's v at an odd time
    stride (65: element-wise loads, 32-column tiles) and xlstm's cut to
    dv 512 (even strides: paired loads, 16-column tiles)."""
    if arch == "zamba2":
        return torch.cat([v, v[..., :1]], dim=-1)[..., :v.shape[-1]], h0
    return v[..., :512].contiguous(), h0[..., :512].contiguous()


def _storage_bytes(t) -> int:
    """Bytes a tensor's elements occupy, counting a broadcast (stride 0)
    axis once: what a call must read of it."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _worst_head_rel(torch, got, want):
    """The largest error of any (batch, head) relative to that head's own
    largest magnitude, and the flat index of that head. A head whose
    reference is all zero must come out exactly zero."""
    err = (got - want).abs().flatten(2).amax(-1).flatten()
    peak = want.abs().flatten(2).amax(-1).flatten()
    rel = torch.where(peak > 0, err / peak.clamp_min(1e-30),
                      torch.where(err > 0, torch.inf, 0.0))
    worst = int(rel.argmax())
    return float(rel[worst]), worst


def phase_ssd_scan(torch, flush):
    """The SSD-scan kernel against ``ssd_scan_ref`` (the sequential scan)
    at both families' prefill shapes, at the published Zamba2's training
    shape (``train_4k``: b=1, 80 heads, S=4,096, bf16, timed as the path
    rows), S=200 (ragged) and S=1, and in bf16 one past a 64-step
    chunk (zamba2, S=65 and 129) and with the bf16 entry's other two v
    layouts (``_relayout``), with a nonzero h0 in all but the path and
    train_4k rows. y and h_final each within 1e-4 (f32) or
    2e-2 (bf16) of the plain version, relative to its largest magnitude,
    over the whole tensor and in every (batch, head) on its own:
    the kernel sums each chunk's products in another order than the
    step-by-step scan, across 512 (or 4,096) steps; the bf16 kernel rounds the
    gated scores and w o v to bf16 and carries H's hi/lo split into
    q . H, and bf16 y rounds once more. No single PyTorch call computes
    a gated linear recurrence, so there is no library time."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.ref import ssd_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(4)
    s_path = RECURRENT["pad_len"]
    rows = []
    for kind, arch, s, dtype, h0_scale in [
            ("path", "zamba2", s_path, torch.bfloat16, 0.0),
            ("path", "zamba2", s_path, torch.float32, 0.0),
            ("path", "xlstm", s_path, torch.bfloat16, 0.0),
            ("path", "xlstm", s_path, torch.float32, 0.0),
            ("train_4k", "zamba2", ZAMBA2_PUBLISHED["seq"], torch.bfloat16,
             0.0),
            ("ragged", "zamba2", 200, torch.bfloat16, 0.5),
            ("ragged", "xlstm", 200, torch.float32, 0.5),
            ("ragged", "xlstm", 200, torch.bfloat16, 0.5),
            ("edge", "zamba2", 65, torch.bfloat16, 0.5),
            ("edge", "zamba2", 129, torch.bfloat16, 0.5),
            ("layout", "zamba2", 200, torch.bfloat16, 0.5),
            ("layout", "xlstm", 200, torch.bfloat16, 0.5),
            ("s1", "zamba2", 1, torch.float32, 0.5),
            ("s1", "xlstm", 1, torch.bfloat16, 0.5)]:
        q, k, v, log_a, h0 = _ssd_inputs(torch, gen, arch, s, dtype,
                                         h0_scale)
        if kind == "layout":
            v, h0 = _relayout(torch, arch, v, h0)
        y, h = ss.ssd_scan_fwd(q, k, v, log_a, h0)
        y_ref, h_ref = ssd_scan_ref(q, k, v, log_a, h0)
        torch.cuda.synchronize()
        name = str(dtype).replace("torch.", "")
        tol = SSD_TOL[name]
        err = float((y.float() - y_ref.float()).abs().max())
        h_err = float((h - h_ref).abs().max())
        y_max = float(y_ref.float().abs().max())
        h_max = float(h_ref.abs().max())
        check(y.dtype == dtype and y.shape == v.shape
              and h.shape == h0.shape and h.dtype == torch.float32,
              f"ssd_scan {arch} S={s}: bad outputs")
        check(bool(torch.isfinite(y.float()).all())
              and bool(torch.isfinite(h).all()),
              f"ssd_scan {arch} S={s} {name}: non-finite output")
        check(err <= tol * max(y_max, 1e-30)
              and h_err <= tol * max(h_max, 1e-30),
              f"ssd_scan {arch} S={s} {name}: y err {err} (max {y_max}), "
              f"h err {h_err} (max {h_max}) beyond {tol} relative")
        # and each (batch, head) against its own largest magnitude, so a
        # head of small values (zamba2's fast decays) is held as tightly
        y_head, y_head_at = _worst_head_rel(torch, y.float(), y_ref.float())
        h_head, h_head_at = _worst_head_rel(torch, h, h_ref)
        check(y_head <= tol and h_head <= tol,
              f"ssd_scan {arch} S={s} {name}: per-head relative error y "
              f"{y_head} (head {y_head_at}), h {h_head} (head {h_head_at}) "
              f"beyond {tol}")
        b, nh, _, dk = q.shape
        dv = v.shape[3]
        nbytes = (sum(_storage_bytes(t) for t in (q, k, v, log_a, h0))
                  + _nbytes(y, h))
        bound = attention_bound_ms(nbytes, ssd_flops(b, nh, s, dk, dv),
                                   dtype == torch.bfloat16)
        timed = kind in ("path", "train_4k")
        row = _row(kind, dtype, err, tol,
                   device_ms(torch, lambda: ss.ssd_scan_fwd(
                       q, k, v, log_a, h0), flush=flush) if timed else None,
                   device_ms(torch, lambda: ssd_scan_ref(
                       q, k, v, log_a, h0), reps=5, flush=flush)
                   if timed else None,
                   None, bound, arch=arch, b=b, nh=nh, S=s, dk=dk, dv=dv,
                   qk_head_stride=q.stride(1), v_time_stride=v.stride(2))
        row.update(y_rel_err=err / max(y_max, 1e-30), h_max_abs_err=h_err,
                   h_rel_err=h_err / max(h_max, 1e-30), y_max_abs=y_max,
                   h_max_abs=h_max,
                   y_ref_rms=float(y_ref.float().pow(2).mean().sqrt()),
                   h_ref_rms=float(h_ref.pow(2).mean().sqrt()),
                   y_head_rel_err=y_head, y_worst_head=y_head_at,
                   h_head_rel_err=h_head, h_worst_head=h_head_at,
                   h0_scale=h0_scale, tol_is_relative=True)
        rows.append(row)
        emit("ssd_scan", **row)
    return rows


#: the trainer's scan shapes (train_recurrent: batch 2 of 128 tokens)
SSD_TRAIN = dict(b=2, s=128)


def phase_ssd_scan_grad(torch, flush):
    """The SSD scan's autograd Function on the card (``_SsdScanFn``: the
    kernel forward; the backward kernel for zamba2's bf16 calls,
    ``ssd_scan._bwd_takes_kernel``, the plain chunked scan's VJP for the
    others) against
    autograd of the plain sequential scan (``ssd_scan_ref``) at both
    trainer shapes (zamba2: b=2, 80 heads, S=128, dk=dv=64, B and C one
    [b, 1, S, 64] leaf broadcast at head stride 0; xlstm: b=2, 4 heads,
    dk 512, dv 513), in f32 and bf16, with a nonzero h0 and both
    cotangents (dy and dh_final). The forward (y and h_final, from the
    kernel) is held as ``phase_ssd_scan`` holds it: each (batch, head)
    within 1e-4 (f32) or 2e-2 (bf16) of its own largest magnitude. Each
    gradient is held by its own dtype (dB and dC summed over the heads
    by the broadcast): an f32 gradient
    (every one of an f32 call; dlog_a and dh0, whose inputs are f32, of
    a bf16 call) within 1e-4 of its largest magnitude; a bf16 one (dq,
    dk, dv of a bf16 call) within 2e-2 of its own largest magnitude in
    every (batch, head), the forward gate's measure. dlog_a is not held
    per head: a head of fast decays (zamba2's last heads, a ~ -55 a
    step) has a near-zero dlog_a, the sum of large terms of both signs,
    so the chunked and sequential f32 sums part there by their rounding
    (1.7e-2 of such a head's own peak, 1.1e-5 of the whole, on the CPU
    at these shapes). Prints the forward kernel's, the plain
    backward's (``ssd_scan_bwd``) and the plain forward's device times
    beside the forward's bound. Returns the rows."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.ref import ssd_scan_bwd, ssd_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for arch in ("zamba2", "xlstm"):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, log_a, h0 = _ssd_inputs(
                torch, gen, arch, SSD_TRAIN["s"], dtype, 0.5,
                b=SSD_TRAIN["b"])
            leaves = [(x[:, :1] if arch == "zamba2" and i < 2 else x)
                      .detach().clone().requires_grad_()
                      for i, x in enumerate((q, k, v, log_a, h0))]
            dy = torch.randn(v.shape, generator=gen, device="cuda"
                             ).to(dtype)
            dh = torch.randn(h0.shape, generator=gen, device="cuda")

            def grads(fn):
                qq, kk = (x.expand(q.shape) for x in leaves[:2])
                y, h = fn(qq, kk, *leaves[2:])
                g = torch.autograd.grad((y, h), leaves, (dy, dh))
                return y.detach(), h.detach(), g

            y, h, got = grads(ss.ssd_scan_fwd)
            y_ref, h_ref, want = grads(ssd_scan_ref)
            torch.cuda.synchronize()
            name = str(dtype).replace("torch.", "")
            # the forward the trainer runs at this shape, as phase_ssd_scan
            # holds it: y and h_final in every (batch, head)
            tol = SSD_TOL[name]
            check(y.dtype == dtype and y.shape == v.shape
                  and h.dtype == torch.float32 and h.shape == h0.shape,
                  f"ssd_scan_grad {arch} {name}: bad forward outputs")
            check(bool(torch.isfinite(y.float()).all())
                  and bool(torch.isfinite(h).all()),
                  f"ssd_scan_grad {arch} {name}: non-finite forward")
            y_head, y_head_at = _worst_head_rel(torch, y.float(),
                                                y_ref.float())
            h_head, h_head_at = _worst_head_rel(torch, h, h_ref)
            check(y_head <= tol and h_head <= tol,
                  f"ssd_scan_grad {arch} {name}: forward per-head relative "
                  f"error y {y_head} (head {y_head_at}), h {h_head} "
                  f"(head {h_head_at}) beyond {tol}")
            fwd = {"y_max_abs_err": float((y.float() - y_ref.float())
                                          .abs().max()),
                   "y_head_rel_err": y_head, "y_worst_head": y_head_at,
                   "h_max_abs_err": float((h - h_ref).abs().max()),
                   "h_head_rel_err": h_head, "h_worst_head": h_head_at,
                   "tol": tol}
            errs = {}
            for gname, g, w in zip(("dq", "dk", "dv", "dlog_a", "dh0"),
                                   got, want):
                check(g.dtype == w.dtype and g.shape == w.shape,
                      f"ssd_scan_grad {arch} {name}: {gname} is "
                      f"{g.dtype} {tuple(g.shape)}")
                check(bool(torch.isfinite(g.float()).all()),
                      f"ssd_scan_grad {arch} {name}: {gname} not finite")
                err = float((g.float() - w.float()).abs().max())
                peak = float(w.float().abs().max())
                gtol = SSD_TOL[str(g.dtype).replace("torch.", "")]
                if g.dtype == torch.bfloat16:
                    rel, _ = _worst_head_rel(torch, g.float(), w.float())
                else:
                    rel = err / max(peak, 1e-30)
                errs[gname] = {"max_abs_err": err, "rel_err": rel,
                               "tol": gtol, "ref_max_abs": peak}
                check(rel <= gtol, f"ssd_scan_grad {arch} {name}: {gname} "
                                   f"relative error {rel} > {gtol}")
            b, nh, s, dk = q.shape
            dv = v.shape[3]
            nbytes = (sum(_storage_bytes(t) for t in (q, k, v, log_a, h0))
                      + _nbytes(v, h0.float()))
            bound = attention_bound_ms(nbytes, ssd_flops(b, nh, s, dk, dv),
                                       dtype == torch.bfloat16)
            row = {"arch": arch, "dtype": name, "b": b, "nh": nh, "S": s,
                   "dk": dk, "dv": dv, "forward": fwd, "grads": errs,
                   "fwd_kernel_ms": device_ms(torch, lambda: ss._launch(
                       q, k, v, log_a, h0), flush=flush),
                   "bwd_plain_ms": device_ms(torch, lambda: ssd_scan_bwd(
                       q, k, v, log_a, h0, dy, dh), flush=flush),
                   "fwd_plain_ms": device_ms(torch, lambda: ssd_scan_ref(
                       q, k, v, log_a, h0), reps=5, flush=flush),
                   "fwd_bound_ms": max(bound.values()), **bound}
            rows.append(row)
            emit("ssd_scan_grad", **row)
    return rows


def phase_ssd_scan_bwd(torch, flush, ptxas=()):
    """The SSD scan's backward kernel (``ssd_scan._bwd_launch``, kernels
    ``ssd_bwd_*``, two launches) against the plain ``ssd_scan_bwd`` on
    the same inputs at the call of the cell zamba2-2.7b.fl_train_4k: b 1,
    S 4,096, 80 heads, dk = dv = 64, bf16, B and C one [S, 64] draw at
    head stride 0 (``_ssd_inputs``), h0 zero and no dh_final, as the
    trainer's Mamba2 layers call it. Gates: dq, dk and dv within 8e-3 of
    each (batch, head)'s own peak (a one-ulp bf16 flip is at most 2^-7
    of it), dlog_a within 2e-3 of its whole peak, and ptxas's report of
    both ``ssd_bwd_`` kernels (``ptxas``: the ``ptxas_summary`` entries;
    ``main`` rebuilds every library to have them) present and without
    spills. Prints the kernel's time (L2 flushed) beside its bound
    (FLOPs, 67.9 us: ``ssd_scan_bwd_roofline``'s cost of the cell's
    call, at the forward's 256-step chunks; at the kernel's own 64-step
    chunks the bytes bound it, at 64.1 us), the plain
    backward's time, and those kernels' registers."""
    from portbench import spec
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.ref import ssd_scan_bwd

    gen = torch.Generator(device="cuda").manual_seed(6)
    s = ZAMBA2_PUBLISHED["seq"]
    q, k, v, log_a, h0 = _ssd_inputs(torch, gen, "zamba2", s,
                                     torch.bfloat16, 0.0)
    dy = torch.randn(v.shape, generator=gen, device="cuda").to(v.dtype)
    check(ss._bwd_takes_kernel(q, v, log_a, h0),
          "ssd_scan_bwd: the cell's call does not take the kernel")
    got = ss._bwd_launch(q, k, v, log_a, h0, dy, None, False)
    want = ssd_scan_bwd(q, k, v, log_a, h0, dy, None)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w, tol in zip(("dq", "dk", "dv", "dlog_a"), got, want,
                               (8e-3, 8e-3, 8e-3, 2e-3)):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"ssd_scan_bwd: {name} is {g.dtype} {tuple(g.shape)}")
        check(bool(torch.isfinite(g.float()).all()),
              f"ssd_scan_bwd: {name} not finite")
        peak = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        if name == "dlog_a":
            rel, at = err / max(peak, 1e-30), None
        else:
            rel, at = _worst_head_rel(torch, g.float(), w.float())
        errs[name] = {"max_abs_err": err, "rel_err": rel, "worst_head": at,
                      "tol": tol, "ref_max_abs": peak}
        check(rel <= tol, f"ssd_scan_bwd: {name} relative error {rel} "
                          f"(head {at}) > {tol}")
    kernels = [r for r in ptxas if "ssd_bwd_" in r["kernel"]]
    for stem in ("ssd_bwd_states_kernel", "ssd_bwd_chunk_kernel"):
        check(any(stem in r["kernel"] for r in kernels),
              f"ssd_scan_bwd: ptxas reported no {stem}: {kernels}")
    for r in kernels:
        check(r.get("spill_stores", 0) == 0 and r.get("spill_loads", 0) == 0,
              f"ssd_scan_bwd: {r['kernel']} spills: {r}")
    b, nh, _, dk = q.shape
    bench = spec.Bench()
    flops, nbytes = bench.reader("ssd_scan_bwd_roofline").call_cost(
        bench.config(ZAMBA2_PUBLISHED["config"]), {"batch": b, "seq": s})
    bound = attention_bound_ms(nbytes, flops, True)
    kernel_ms = device_ms(torch, lambda: ss._bwd_launch(
        q, k, v, log_a, h0, dy, None, False), flush=flush)
    plain_ms = device_ms(torch, lambda: ssd_scan_bwd(
        q, k, v, log_a, h0, dy, None), reps=5, flush=flush,
        spin=20_000_000)
    row = {"b": b, "nh": nh, "S": s, "dk": dk, "dv": v.shape[3],
           "dtype": "bfloat16", "qk_head_stride": q.stride(1),
           "grads": errs, "max_abs_err": max(e["max_abs_err"]
                                             for e in errs.values()),
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": max(bound.values()), **bound,
           **shares(kernel_ms, max(bound.values()), None),
           "ptxas": kernels}
    emit("ssd_scan_bwd", **row)
    return row


def _recurrent_prompts(vocab: int, n: int, length: int):
    """``n`` prompts of exactly ``length`` tokens from ``default_rng(0)``
    (recurrent families take fixed-length prompts)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, length).tolist() for _ in range(n)]


def phase_serve_recurrent(torch, smi):
    """zamba2-2.7b and xlstm-350m at full width through
    ``run_sequential``, the recurrent families' serving path: 4 sessions,
    prompts of exactly 512 tokens, 32 new tokens each, bf16, random
    weights from seed 0 drawn on the card. Then one prefill and eight
    decode steps each under ``torch.profiler``: device-busy share and
    the kernels that fill it (the profiler slows the host, so these are
    shares, not speeds)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import group_layout
    from repro_torch.serve import run_sequential
    from repro_torch.tree import tree_leaves

    pad, new, n = (RECURRENT["pad_len"], RECURRENT["max_new"],
                   RECURRENT["sessions"])
    totals = {"ssd_scan": 0, "flash_attention": 0}
    for arch, (n_ssd, n_flash) in RECURRENT_LAUNCHES.items():
        cfg = get_config(arch)
        g, p = group_layout(cfg)
        check(cfg.dtype == "bfloat16" and cfg.attn_impl == "flash"
              and g * (p - 1) == n_ssd
              and (g if cfg.family == "hybrid" else 0) == n_flash,
              f"unexpected config {cfg}")
        model = Model(cfg)
        t0 = time.perf_counter()
        params = model.init(seed=0)             # the default device: cuda
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prompts = _recurrent_prompts(cfg.vocab_size, n, pad)
        run_sequential(model, params, prompts[:1], max_new=2, pad_len=pad)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = run_sequential(model, params, prompts, max_new=new,
                              pad_len=pad)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for k in totals:
            totals[k] += launches[k]

        with torch.inference_mode():
            toks = torch.as_tensor(np.asarray([prompts[0]], np.int32)).cuda()
            logits, _, _ = model.forward(params, toks)
            finite = bool(torch.isfinite(logits).all())
        tokens = sum(len(s.generated) for s in done)
        times = [t for s in done for t in s.token_times[1:]]
        ttft = [s.token_times[0] for s in done]
        emit("serve_recurrent", arch=cfg.name, family=cfg.family,
             params=sum(x.numel() for x in tree_leaves(params)), init_s=init_s,
             sessions=len(done), prompt_len=pad, tokens=tokens,
             elapsed_s=elapsed, tokens_per_s=tokens / elapsed,
             ttft_p50_ms=float(np.percentile(ttft, 50)) * 1e3,
             per_token_p50_ms=float(np.percentile(times, 50)) * 1e3,
             per_token_p99_ms=float(np.percentile(times, 99)) * 1e3,
             peak_memory_bytes=peak, launches=launches,
             expected_per_prefill={"ssd_scan": n_ssd,
                                   "flash_attention": n_flash},
             logits_finite=finite, card=smi)
        check(len(done) == n and all(len(s.generated) == new for s in done),
              f"serve_recurrent {arch}: a session did not finish with "
              f"{new} tokens")
        check(finite, f"serve_recurrent {arch}: logits are not finite")
        check(launches["ssd_scan"] == n * n_ssd,
              f"serve_recurrent {arch}: ssd_scan launched "
              f"{launches['ssd_scan']} times for {n} prefills of {n_ssd}")
        check(launches["flash_attention"] == n * n_flash,
              f"serve_recurrent {arch}: flash launched "
              f"{launches['flash_attention']} times for {n} prefills of "
              f"{n_flash}")

        # one prefill, then eight decode steps, each under the profiler
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_sequential(model, params, prompts[:1], max_new=1,
                           pad_len=pad)
            torch.cuda.synchronize()
            prefill_us = (time.perf_counter() - t0) * 1e6
        emit("serve_recurrent_profile", arch=cfg.name, part="prefill",
             **_device_profile(torch, prof, prefill_us, 1,
                               f"{arch} prefill profile"))
        cache = model.init_cache(1, 16)
        tok = torch.zeros((1,), dtype=torch.int32, device="cuda")
        with torch.inference_mode():
            model.decode_step(params, cache, tok)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(8):
                    logits, cache = model.decode_step(params, cache, tok)
                    tok = logits.argmax(dim=-1).to(torch.int32)
                torch.cuda.synchronize()
                decode_us = (time.perf_counter() - t0) * 1e6
        emit("serve_recurrent_profile", arch=cfg.name, part="decode",
             **_device_profile(torch, prof, decode_us, 8,
                               f"{arch} decode profile"))
        del params, model
        torch.cuda.empty_cache()
    return totals


def phase_recurrent_parity(torch):
    """Both families' widths at reduced depth in f32 (zamba2: 6 layers,
    attn_every 3; xlstm: 4 layers, slstm_every 2): prefill logits of the
    kernel path (``"flash"``: the SSD-scan and flash kernels) against
    the plain path (``"xla"``) within 1e-4, and equal greedy streams
    (prompt 64, 8 new tokens). Where a stream parts, the step and both
    paths' two top logits there are printed: a near tie within the
    tolerance is reported, any other parting fails."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve import run_sequential

    for arch, kw in [("zamba2-2.7b", dict(num_layers=6, attn_every=3)),
                     ("xlstm-350m", dict(num_layers=4, slstm_every=2))]:
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **kw)
        kernel = Model(cfg)
        plain = Model(dataclasses.replace(cfg, attn_impl="xla"))
        params = kernel.init(seed=0)
        prompts = _recurrent_prompts(cfg.vocab_size, 2, 64)
        with torch.inference_mode():
            toks = torch.as_tensor(np.asarray(prompts, np.int32)).cuda()
            lk, _, _ = kernel.forward(params, toks)
            lp, _, _ = plain.forward(params, toks)
            logit_err = float((lk - lp).abs().max())
        sk = run_sequential(kernel, params, prompts, max_new=8, pad_len=64)
        sp = run_sequential(plain, params, prompts, max_new=8, pad_len=64)
        partings = []
        for a, b in zip(sk, sp):
            if a.generated == b.generated:
                continue
            step = next(i for i, (x, y) in enumerate(zip(a.generated,
                                                         b.generated))
                        if x != y)
            ctx = torch.as_tensor(np.asarray(
                [list(a.prompt) + a.generated[:step]], np.int32)).cuda()
            with torch.inference_mode():
                top = {name: torch.topk(m.forward(params, ctx)[0][0, -1],
                                        2).values.tolist()
                       for name, m in (("kernel", kernel), ("plain", plain))}
            tie = all(abs(v[0] - v[1]) <= 1e-4 for v in top.values())
            partings.append({"session": a.sid, "step": step, "top2": top,
                             "near_tie": tie})
        emit("recurrent_parity", arch=arch, dtype="float32", **kw,
             prompt_len=64, max_new=8, sessions=len(prompts),
             streams_equal=sum(a.generated == b.generated
                               for a, b in zip(sk, sp)),
             partings=partings,
             prefill_logits_kernel_vs_plain_max_abs_err=logit_err)
        check(logit_err <= 1e-4, f"recurrent_parity {arch}: kernel vs plain "
                                 f"prefill logits differ by {logit_err}")
        check(all(p["near_tie"] for p in partings),
              f"recurrent_parity {arch}: streams part without a near tie: "
              f"{partings}")
        del params
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the moe family: moonshot-v1-16b-a3b at full width, parity, checkpoints
# ---------------------------------------------------------------------------

MOE_LAYERS = 48
MOE_PARAMS = 28_888_467_456          # the reference's Model.init, counted


def _label_profile(torch, prof, label: str, steps: int) -> dict:
    """Per step: the host time inside ``label``'s ranges, the kernel
    launches issued there and the device time of the work they queued
    (matched by correlation id, as :func:`profile_quickstart` does), and
    that device time's share of all the device time."""
    import bisect

    cpu = torch.autograd.DeviceType.CPU
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    ranges = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.name == label and e.device_type == cpu)
    starts = [a for a, _ in ranges]
    issued, launches = set(), 0
    for e in events:
        if e.device_type != cpu or not any(
                w in e.name for w in ("LaunchKernel", "Memcpy", "Memset")):
            continue
        t = e.time_range.start
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            issued.add(e.id)
            launches += "LaunchKernel" in e.name
    dev = [e for e in events if e.device_type == cuda and e.name != label]
    label_us = sum(e.self_device_time_total for e in dev if e.id in issued)
    busy_us = sum(e.self_device_time_total for e in dev)
    check(ranges and label_us > 0, f"profile: no device time under {label}")
    return {"label": label, "ranges_per_step": len(ranges) / steps,
            "host_ms_per_step": sum(b - a for a, b in ranges) / steps / 1e3,
            "launches_per_step": launches / steps,
            "device_ms_per_step": label_us / steps / 1e3,
            "share_of_busy": label_us / busy_us}


def phase_serve_moe(torch, smi):
    """moonshot-v1-16b-a3b at full width through the port's engine: 48
    layers, d 2048, 16 heads of 128 (kv 16: g = 1), 64 experts top-6 of
    d_ff 1408 and 2 shared, vocab 163,840, bf16, random weights from
    seed 0 drawn on the card; the serve phase's traffic. Then ten decode
    steps and one prefill under ``torch.profiler``, with the MoE expert
    products and combine (label ``moe``) apart."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serve import DecodeServer, ServeConfig
    from repro_torch.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    cfg = get_config("moonshot-v1-16b-a3b")
    check(cfg.family == "moe" and cfg.num_layers == MOE_LAYERS
          and cfg.dtype == "bfloat16" and cfg.attn_impl == "flash"
          and (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
          == (MOONSHOT_ATTN["h"], MOONSHOT_ATTN["kvh"], MOONSHOT_ATTN["d"]),
          f"unexpected config {cfg}")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0)             # the default device: cuda
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    leaves = tree_leaves(params)
    n_params = sum(x.numel() for x in leaves)
    n_bytes = sum(x.numel() * x.element_size() for x in leaves)
    check(n_params == MOE_PARAMS == cfg.param_count(),
          f"serve_moe: {n_params} parameters, expected {MOE_PARAMS}")
    scfg = _serve_config(ServeConfig)
    prompts = _serve_prompts(cfg.vocab_size, SERVE["sessions"],
                             SERVE["pad_len"])

    warm = DecodeServer(model, params, _serve_config(ServeConfig, 2))
    warm.enqueue(prompts[0])
    warm.run()
    del warm

    srv = DecodeServer(model, params, scfg)
    for p in prompts:
        srv.enqueue(p)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = ops.launch_counts()
    srv.assert_quiescent()
    st = srv.stats()
    peak = torch.cuda.max_memory_allocated()

    with torch.inference_mode():
        logits, aux, _ = model.forward(params, _prompt_tokens(torch,
                                                              prompts[0]))
        finite = bool(torch.isfinite(logits).all()) and \
            bool(torch.isfinite(aux))
    del logits
    emit("serve_moe", arch=cfg.name, params=n_params, param_bytes=n_bytes,
         resident_before_bytes=resident, init_s=init_s,
         init_peak_memory_bytes=init_peak, sessions=len(srv.finished),
         prefills=st["prefills"], decode_steps=st["decode_steps"],
         tokens=st["tokens"], elapsed_s=elapsed,
         tokens_per_s=st["tokens"] / elapsed,
         ttft_p50_ms=st["p50_ttft_s"] * 1e3,
         per_token_p50_ms=st["p50_tok_s"] * 1e3,
         per_token_p99_ms=st["p99_tok_s"] * 1e3,
         peak_memory_bytes=peak, launches=launches,
         expected_per_step=MOE_LAYERS, logits_finite=finite, card=smi)
    check(len(srv.finished) == SERVE["sessions"]
          and all(len(s.generated) == SERVE["max_new"]
                  for s in srv.finished),
          "serve_moe: a session did not finish with 64 tokens")
    check(finite, "serve_moe: prefill logits or aux are not finite")
    check(launches["flash_attention"] == st["prefills"] * MOE_LAYERS,
          f"serve_moe: flash launched {launches['flash_attention']} times "
          f"for {st['prefills']} prefills of {MOE_LAYERS} layers")
    check(launches["paged_decode_attention"]
          == st["decode_steps"] * MOE_LAYERS,
          f"serve_moe: paged kernel launched "
          f"{launches['paged_decode_attention']} times for "
          f"{st['decode_steps']} decode steps")

    prof_srv = DecodeServer(model, params, scfg)
    for p in prompts[:SERVE["max_batch"]]:
        prof_srv.enqueue(p)
    prof_srv.step()                       # admits all eight, one decode
    torch.cuda.synchronize()
    steps = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            prof_srv.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    emit("serve_moe_profile", part="decode", steps=steps,
         batch=len(prof_srv.running),
         moe=_label_profile(torch, prof, "moe", steps),
         **_device_profile(torch, prof, wall_us, steps,
                           "serve_moe decode profile", labels=("moe",)))
    del prof_srv
    toks = _prompt_tokens(torch, prompts[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.inference_mode():
            model.forward(params, toks)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    emit("serve_moe_profile", part="prefill", pad_len=SERVE["pad_len"],
         moe=_label_profile(torch, prof, "moe", 1),
         **_device_profile(torch, prof, wall_us, 1,
                           "serve_moe prefill profile", labels=("moe",)))
    del params, srv, prof
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_serve_moe_parity(torch):
    """moonshot's widths at 2 layers in f32: the engine's greedy streams
    (paged kernel; batch 8 keeps the decode capacity at 8, so no
    assignment drops) equal the sequential baseline's (plain dense
    decode), a second engine run gives the same streams (the combine is
    deterministic), and the flash kernel's prefill logits agree with the
    plain path's within 1e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve import DecodeServer, ServeConfig, run_sequential

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                              num_layers=2, dtype="float32")
    model = Model(cfg)
    params = model.init(seed=0)
    prompts = _serve_prompts(cfg.vocab_size, 12, SERVE["pad_len"])
    runs = []
    for _ in range(2):
        srv = DecodeServer(model, params, _serve_config(ServeConfig))
        for p in prompts:
            srv.enqueue(p)
        srv.run()
        srv.assert_quiescent()
        runs.append({s.sid: s.generated for s in srv.finished})
    seq = run_sequential(model, params, prompts, max_new=SERVE["max_new"],
                         pad_len=SERVE["pad_len"])
    same = [runs[0][s.sid] == s.generated for s in seq]
    with torch.inference_mode():
        toks = _prompt_tokens(torch, prompts[0])
        flash, aux_k, _ = model.forward(params, toks)
        plain, aux_p, _ = Model(dataclasses.replace(cfg, attn_impl="xla")) \
            .forward(params, toks)
        logit_err = float((flash - plain).abs().max())
    emit("serve_moe_parity", layers=2, dtype="float32",
         sessions=len(prompts), streams_equal=sum(same),
         engine_reruns_equal=runs[0] == runs[1],
         engine_decode_steps=srv.decode_steps,
         prefill_logits_flash_vs_xla_max_abs_err=logit_err,
         aux_flash_vs_xla=[float(aux_k), float(aux_p)])
    check(all(same), f"serve_moe_parity: {len(same) - sum(same)} of "
                     f"{len(same)} engine streams differ from sequential")
    check(runs[0] == runs[1], "serve_moe_parity: two engine runs differ")
    check(logit_err <= 1e-4, f"serve_moe_parity: flash vs xla prefill "
                             f"logits differ by {logit_err} > 1e-4")
    del params
    torch.cuda.empty_cache()


def _same_bits(torch, a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}.get(
        a.element_size(), torch.uint8)
    return torch.equal(a.contiguous().view(view).cpu(),
                       b.contiguous().view(view).cpu())


def phase_checkpoint(torch):
    """Checkpoints and the hot-swap on the card, moonshot's smoke config
    (bf16 experts, f32 router): an FL state ``{"params", "momentum"}``
    with a peer axis of 3 saved and restored bit for bit, with and
    without ``like``; then an engine polling the directory every 2 steps
    swaps a newer step in mid-drain, no session dropped, its weights bit
    for bit the peer mean ``serving_params_from_checkpoint`` makes on
    the CPU."""
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    from repro_torch.serve import (DecodeServer, ServeConfig,
                                   serving_params_from_checkpoint)
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    model = Model(cfg)
    params = model.init(seed=0)

    def fl_state(scale):
        def peers(x):
            return torch.stack([x, x * scale, x * (2 - scale)])
        return {"params": tree_map(peers, params),
                "momentum": tree_map(lambda x: peers(x) * 0.1, params)}

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp, keep=2)
        state = fl_state(1.5)
        t0 = time.perf_counter()
        ck.save(1, state, metadata={"n_peers": 3})
        out["save_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got, meta = ck.restore()                # the default device: cuda
        torch.cuda.synchronize()
        out["restore_ms"] = (time.perf_counter() - t0) * 1e3
        liked, _ = ck.restore(like=state)
        want = tree_leaves(state)
        dtypes = sorted({str(x.dtype) for x in want})
        ok_plain = all(_same_bits(torch, a, b) and a.is_cuda
                       for a, b in zip(tree_leaves(got), want))
        ok_like = all(_same_bits(torch, a, b) and a.is_cuda
                      for a, b in zip(tree_leaves(liked), want))
        out.update(leaves=len(want), dtypes=dtypes, meta=meta,
                   bit_exact_without_like=ok_plain,
                   bit_exact_with_like=ok_like)
        check(ok_plain and ok_like and meta == {"n_peers": 3},
              f"checkpoint: a restore is not bit for bit: {out}")

        scfg = ServeConfig(max_batch=2, block_size=4, num_blocks=40,
                           pad_len=12, max_new=8)
        srv = DecodeServer(model, params, scfg)
        srv.attach_checkpointer(Checkpointer(tmp), params, every=2)
        for p in _serve_prompts(cfg.vocab_size, 4, 12):
            srv.enqueue(p)
        for _ in range(3):
            srv.step()
        ck.save(2, fl_state(1.25), metadata={"n_peers": 3})
        srv.run()
        srv.assert_quiescent()
        state_cpu, _ = ck.restore(2, device="cpu")
        want = serving_params_from_checkpoint(
            state_cpu, tree_map(lambda x: x.cpu(), params))
        swapped = all(_same_bits(torch, a, b) and a.is_cuda
                      for a, b in zip(tree_leaves(srv.params),
                                      tree_leaves(want)))
        out.update(swap_log=srv.swap_log,
                   sessions=len(srv.finished),
                   tokens=[len(s.generated) for s in srv.finished],
                   swapped_bit_equal_to_cpu_fold=swapped)
    emit("checkpoint", arch=cfg.name, **out)
    check(len(srv.swap_log) == 1 and srv.swap_log[0]["tag"] == "ckpt:2"
          and srv.swap_log[0]["in_flight"],
          f"checkpoint: expected one mid-drain swap to ckpt:2, got "
          f"{srv.swap_log}")
    check(len(srv.finished) == 4
          and all(len(s.generated) == 8 for s in srv.finished),
          "checkpoint: a session was dropped or cut short by the swap")
    check(swapped, "checkpoint: the swapped weights are not the CPU fold")


def _bit_equal_peers(torch, tree_leaves, tree) -> bool:
    """Every peer's slice of every leaf equal to peer 0's, bit for bit."""
    return all(torch.equal(x[i], x[0]) for x in tree_leaves(tree)
               for i in range(1, x.shape[0]))


def state_digests(torch, tree_leaves, state) -> list:
    """Per leaf of theta then m, per peer: the sums of the bit patterns
    and of their squares, mod 2^64 (exact, so in any order), taken in
    blocks so no leaf-sized int64 copy is made. Equal states give equal
    digests."""
    out = []
    for x in tree_leaves(state["params"]) + tree_leaves(state["momentum"]):
        if hasattr(x, "to_local"):
            x = x.to_local()
        bits = {2: torch.int16, 4: torch.int32}[x.element_size()]
        for i in range(x.shape[0]):
            flat = x[i].reshape(-1).view(bits)
            s1 = torch.zeros((), dtype=torch.int64, device=x.device)
            s2 = torch.zeros((), dtype=torch.int64, device=x.device)
            for c0 in range(0, flat.numel(), 1 << 26):
                b = flat[c0:c0 + (1 << 26)].long()
                s1 += b.sum()
                s2 += (b * b).sum()
                del b
            out.append((int(s1), int(s2)))
    return out


def _train_full_width(torch, smi, phase: str, args, expect: dict,
                      record=None) -> dict:
    """One full-width run of ``launch.train.main`` in process (``args``:
    its command line), the state updated in place. After every step
    every peer's theta and m are bit-equal (full participation over
    (2, 2) is a global mean broadcast to all); each kernel of ``expect``
    (``{kernel: launches a step}``; ``ssd_scan_bwd``: the SSD backward
    kernel's) launches that often a step; the
    ledger is ``expect["comm_bytes"]``; the peak is under the card's
    memory. Then one more step under ``torch.profiler`` (with the SSD
    scan's backward under its own label where the scan runs).
    With ``record`` (a dict), the state's digests after each of the
    first TRAIN_MESH_STEPS steps go to ``record["digests"]`` and the
    median ms a step to ``record["median_ms"]``, for train_mesh.
    Returns the main path's launch counts."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.fl_device import SPAN_AGGREGATE, SPAN_LOCAL
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    n_steps = int(args[args.index("--steps") + 1])
    steps, seen = [], {}

    def on_step(info):
        state = info["state"]
        steps.append({"step": info["t"] + 1,
                      "loss": float(info["metrics"]["loss"]),
                      "ms": info["seconds"] * 1e3,
                      "peers_bit_equal": _bit_equal_peers(
                          torch, tree_leaves, state["params"])
                      and _bit_equal_peers(torch, tree_leaves,
                                           state["momentum"])})
        emit(f"{phase}_step", **steps[-1])
        if record is not None and info["t"] < TRAIN_MESH_STEPS:
            record.setdefault("digests", []).append(
                state_digests(torch, tree_leaves, state))
        if info["t"] + 1 < n_steps:
            return
        # the main path ends here: read its counts before the extra step
        seen["launches"] = {**ops.launch_counts(),
                            "ssd_scan_bwd": ss.backward_launches}
        seen["ledger"] = info["ledger"].total_bytes
        seen["peak"] = torch.cuda.max_memory_allocated()
        seen["params_per_peer"] = sum(x[0].numel() for x in
                                      tree_leaves(state["params"]))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            info["step_fn"](state, info["batch"])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        labels = (SPAN_LOCAL, SPAN_AGGREGATE, ss.SPAN_BACKWARD)
        seen["profile"] = {
            "local_update": _label_profile(torch, prof, SPAN_LOCAL, 1),
            "aggregate": _label_profile(torch, prof, SPAN_AGGREGATE, 1),
            **_device_profile(torch, prof, wall_us, 1, f"{phase} profile",
                              labels=labels)}
        if expect.get("ssd_scan"):      # the scan's backward
            seen["profile"]["ssd_scan_backward"] = _label_profile(
                torch, prof, ss.SPAN_BACKWARD, 1)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ss.backward_launches = 0
    t0 = time.perf_counter()
    check(train.main(list(args), on_step=on_step) == 0,
          f"{phase}: main did not return 0")
    run_s = time.perf_counter() - t0
    ms = [st["ms"] for st in steps]
    med = statistics.median(ms[1:])
    launches = seen["launches"]
    total = torch.cuda.get_device_properties(0).total_memory
    kernels = {k: v for k, v in expect.items() if k in launches}
    arch = args[args.index("--arch") + 1]
    emit(phase, arch=arch, args=list(args),
         params_per_peer_tree=seen["params_per_peer"],
         losses=[st["loss"] for st in steps], first_step_ms=ms[0],
         median_ms_steps_2_6=med,
         tokens_per_s=TRAIN_TOKENS_PER_STEP / (med / 1e3),
         peak_memory_bytes=seen["peak"],
         peak_gb=seen["peak"] / 1e9, card_memory_bytes=total,
         launches=launches,
         expected_launches={k: v * len(steps) for k, v in kernels.items()},
         comm_total_bytes=seen["ledger"], run_s=run_s, card=smi)
    emit(f"{phase}_profile", arch=arch, **seen["profile"], card=smi)
    check(len(steps) == n_steps, f"{phase}: {len(steps)} steps ran")
    check(all(math.isfinite(st["loss"]) for st in steps),
          f"{phase} {arch}: a loss is not finite: "
          f"{[st['loss'] for st in steps]}")
    check(all(st["peers_bit_equal"] for st in steps),
          f"{phase} {arch}: the peers' theta or m differ after a step")
    for name, per_step in kernels.items():
        check(launches[name] == per_step * len(steps),
              f"{phase} {arch}: {name} launched {launches[name]} times, "
              f"expected {per_step * len(steps)}")
    check(seen["ledger"] == expect["comm_bytes"],
          f"{phase} {arch}: ledger {seen['ledger']} != the reference's "
          f"{expect['comm_bytes']}")
    check(seen["peak"] < total,
          f"{phase} {arch}: peak {seen['peak']} >= the card's {total}")
    check(seen["params_per_peer"] == expect.get("params",
                                                seen["params_per_peer"]),
          f"{phase} {arch}: {seen['params_per_peer']} parameters a peer, "
          f"expected {expect.get('params')}")
    if record is not None:
        record["median_ms"] = med
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train(torch, smi, record=None):
    """musicgen-medium at full width through the port's trainer: 48
    layers, d 1536, 24 MHA heads of 64, gated FFN 6144, vocab 2048,
    bf16; 4 peers on the (2, 2) grid, each a materialized copy of
    1,818,379,776 parameters (f32 momentum), batch 2 of 128 tokens a
    peer, one local step, 6 steps, seed 0; flash launches
    TRAIN_FLASH_PER_STEP times a step (``_train_full_width``)."""
    from repro_torch.configs import get_config

    cfg = get_config("musicgen-medium")
    check(cfg.family == "audio" and cfg.num_layers == TRAIN_LAYERS
          and cfg.dtype == "bfloat16" and cfg.attn_impl == "flash"
          and cfg.remat == "block" and cfg.param_count() == TRAIN_PARAMS
          and (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
          == (TRAIN_ATTN["h"], TRAIN_ATTN["kvh"], TRAIN_ATTN["d"]),
          f"unexpected config {cfg}")
    return _train_full_width(torch, smi, "train", TRAIN_ARGS, {
        "flash_attention": TRAIN_FLASH_PER_STEP, "ssd_scan": 0,
        "ssd_scan_bwd": 0, "mar_rounds": TRAIN_MAR_ROUNDS_PER_STEP,
        "comm_bytes": TRAIN_COMM_BYTES}, record)


def phase_train_recurrent(torch, smi):
    """zamba2-2.7b (54 layers: 45 Mamba2 and 9 applications of one shared
    attention block, d 2560; 2,063,209,520 parameters) and xlstm-350m
    (21 mLSTM + 3 sLSTM, d 1024; 518,640,640) trained at full width,
    bf16, seed 0, with the musicgen run's traffic (TRAIN_ARGS): the
    SSD-scan kernel in every Mamba2 / mLSTM layer's forward and remat
    recompute, flash in zamba2's shared block, the scan's backward
    through its kernel (zamba2's Mamba2: dk = dv = 64, two launches a
    layer and peer) or the plain
    chunked scan's VJP (xlstm's mLSTM: dk 512) (``_train_full_width``'s
    gates, the launch counts of TRAIN_RECURRENT). Returns the summed
    launch counts."""
    from repro_torch.configs import get_config

    totals = {}
    for arch, want in TRAIN_RECURRENT.items():
        cfg = get_config(arch)
        check(cfg.family in ("ssm", "hybrid") and cfg.dtype == "bfloat16"
              and cfg.attn_impl == "flash" and cfg.remat == "block",
              f"unexpected config {cfg}")
        args = ("--arch", arch, *TRAIN_ARGS[2:])
        launches = _train_full_width(torch, smi, "train_recurrent", args, {
            "ssd_scan": want["ssd_per_step"],
            "ssd_scan_bwd": want["ssd_bwd_per_step"],
            "flash_attention": want["flash_per_step"],
            "mar_rounds": want["mar_rounds_per_step"],
            "comm_bytes": want["comm_bytes"], "params": want["params"]})
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    return totals


def phase_train_zamba2(torch, smi):
    """The published Zamba2-2.7B (``models/zamba2.py``) at the shape of
    ``zamba2-2.7b.fl_train_4k`` (ZAMBA2_PUBLISHED): the port's own init
    (seed 0), ``init_fl_state`` and ``make_fl_train_step`` over the grid
    (2,), as the benchmark's entry drives them, bf16, 3 steps of fresh
    token batches. Gates: the counted parameters, a finite loss, both
    peers' theta and m bit-equal after every step (a group of two means
    to one value), the launch counts of flash (d = 160 at Zamba2's
    scale), ssd_scan, the SSD backward kernel (``ssd_scan_bwd``, two
    launches a call) and mar_rounds, counted from 0 just before the
    first step, and the peak under the card's memory. Returns the launch
    counts."""
    import gc

    from portbench import spec
    from repro_torch.core.fl_device import init_fl_state, make_fl_train_step
    from repro_torch.core.moshpit import plan_grid
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves

    z = ZAMBA2_PUBLISHED
    bench = spec.Bench()
    cfg = bench.entry("fl_train_zamba2").port_config(
        bench.config(z["config"]))
    check(cfg.param_count() == z["params"] and cfg.head_dim == 160
          and cfg.dtype == "bfloat16" and cfg.remat == "block",
          f"unexpected config {cfg}")
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(cfg)
    peers, seq = z["peers"], z["seq"]
    state = init_fl_state(model, peers, seed=0, device="cuda")
    step_fn = make_fl_train_step(model, plan_grid(peers))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = []
    for _ in range(z["steps"]):
        ids = torch.randint(0, cfg.vocab_size, (peers, 1, 1, 1, seq + 1),
                            generator=gen, device="cuda")
        batches.append({"tokens": ids[..., :-1].int().contiguous(),
                        "labels": ids[..., 1:].int().contiguous()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ss.backward_launches = 0
    steps = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        torch.cuda.synchronize()
        steps.append({"step": i + 1, "loss": float(met["loss"]),
                      "ms": (time.perf_counter() - t0) * 1e3,
                      "peers_bit_equal": _bit_equal_peers(
                          torch, tree_leaves, state["params"])
                      and _bit_equal_peers(torch, tree_leaves,
                                           state["momentum"])})
        emit("train_zamba2_step", **steps[-1])
    launches = {**ops.launch_counts(), "ssd_scan_bwd": ss.backward_launches}
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    n = len(steps)
    expect = {"flash_attention": z["flash_per_step"] * n,
              "ssd_scan": z["ssd_per_step"] * n,
              "ssd_scan_bwd": z["ssd_bwd_per_step"] * n,
              "mar_rounds": z["mar_rounds_per_step"] * n}
    emit("train_zamba2", config=z, leaves=len(tree_leaves(state["params"])),
         losses=[st["loss"] for st in steps], first_step_ms=steps[0]["ms"],
         median_ms_steps_2_3=statistics.median(st["ms"] for st in steps[1:]),
         peak_memory_bytes=peak, card_memory_bytes=total, launches=launches,
         expected_launches=expect, card=smi)
    check(all(math.isfinite(st["loss"]) for st in steps),
          f"train_zamba2: a loss is not finite: "
          f"{[st['loss'] for st in steps]}")
    check(all(st["peers_bit_equal"] for st in steps),
          "train_zamba2: the peers' theta or m differ after a step")
    for name, want in expect.items():
        check(launches[name] == want,
              f"train_zamba2: {name} launched {launches[name]} times, "
              f"expected {want}")
    check(peak < total, f"train_zamba2: peak {peak} >= the card's {total}")
    del state, step_fn, batches
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _parity_batches(np, cfg, n: int, steps: int, prefix: int):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (n, 2, 2, 1, 32))
        b = {"tokens": toks.astype(np.int32),
             "labels": np.roll(toks, -1, -1).astype(np.int32)}
        if prefix:
            b["prefix_embeds"] = rng.normal(
                size=(n, 2, 2, 1, prefix, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def phase_train_parity(torch):
    """The trainer's checks at reduced depth: starcoder2-3b's and
    musicgen-medium's smoke configs (the latter with prefix embeddings)
    at 2 layers in f32, one theta^0 and one batch stream (2 local steps
    of 2 microbatches), ``make_fl_train_step`` on the card and on the
    CPU for 3 steps, under full participation and under U != A masks
    with int8 EF and a bf16 wire: every loss within 1e-4, the final
    theta within 1e-4 (with int8, a rounding within the two devices'
    f32 differences of a half-quantum may become a quantum: such flips
    <= 0.5% of a leaf and <= 2 quanta of the leaf's largest value). Then
    a ``--resize-at`` CLI run on the card with the survivors bit-exact
    across the resize and the reference's comm line.
    """
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    for arch in ("starcoder2-3b", "musicgen-medium"):
        cfg = dataclasses.replace(get_smoke_config(arch), num_layers=2,
                                  dtype="float32")
        _card_vs_cpu(torch, "train_parity", cfg,
                     ("full", "int8_ef_bf16"))

    # --resize-at on the card: survivors bit-exact, the reference's line
    seen = []
    real = train.apply_membership

    def spy(state, change, pipeline=None):
        before = [x.clone() for x in tree_leaves(state["params"])
                  + tree_leaves(state["momentum"])]
        out = real(state, change, pipeline)
        after = tree_leaves(out[0]["params"]) \
            + tree_leaves(out[0]["momentum"])
        seen.append(all(torch.equal(a[j], b[int(s)])
                        for a, b in zip(after, before)
                        for j, s in enumerate(change.survivors)))
        return out

    import contextlib
    import io

    buf = io.StringIO()
    train.apply_membership = spy
    try:
        with contextlib.redirect_stdout(buf):
            train.main(["--arch", "starcoder2-3b", *TRAIN_CLI_BASE,
                        *TRAIN_CLI_CASES["resize"]])
    finally:
        train.apply_membership = real
    line = next(ln for ln in buf.getvalue().splitlines()
                if ln.startswith("[train] comm total="))
    emit("train_resize", survivors_bit_exact=seen, comm_line=line)
    check(seen == [True], f"train_resize: survivors {seen}")
    check(line == TRAIN_CLI_COMM["starcoder2-3b resize"],
          f"train_resize: {line!r} is not the reference's")


def _card_vs_cpu(torch, phase: str, cfg, cases) -> None:
    """3 steps of ``make_fl_train_step`` from one theta^0 and one batch
    stream (2 local steps of 2 microbatches) on the card and on the CPU,
    for each case (``"full"``, or ``"int8_ef_bf16"``: U != A masks, int8
    EF over a bf16 wire): losses within 1e-4, the final theta within
    1e-4 (int8: the flip rule of ``phase_train_parity``)."""
    import numpy as np

    from repro_torch.core.aggregation import build_pipeline
    from repro_torch.core.fl_device import init_fl_state, make_fl_train_step
    from repro_torch.core.moshpit import plan_grid
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import PREFIX_LEN
    from repro_torch.tree import tree_leaves

    masks = {1: ([1, 0, 1, 1], [1, 0, 0, 1]), 2: ([1, 1, 1, 1],
                                                  [1, 1, 0, 1])}
    arch = cfg.name
    model = Model(cfg)
    prefix = PREFIX_LEN.get(cfg.frontend, 0)
    theta0 = model.init(seed=0, device="cpu")
    batches = _parity_batches(np, cfg, 4, 3, prefix)
    for case in cases:
        wire = (dict(compress="int8_ef", comm_dtype="bfloat16")
                if case != "full" else {})
        runs = {}
        for dev in ("cpu", "cuda"):
            grid = plan_grid(4)
            pipe = build_pipeline("mar", grid, backend="device", **wire)
            st = init_fl_state(model, 4, device=dev, pipeline=pipe,
                               params=theta0)
            step = make_fl_train_step(model, grid, lr=0.1, pipeline=pipe)
            losses = []
            for t, b in enumerate(batches):
                mk = {}
                if case != "full" and t in masks:
                    mk = {"mask": torch.tensor(masks[t][0],
                                               dtype=torch.float32),
                          "agg_mask": torch.tensor(
                              masks[t][1], dtype=torch.float32)}
                st, met = step(st, {k: torch.from_numpy(v)
                                    for k, v in b.items()}, **mk)
                losses.append(float(met["loss"]))
            runs[dev] = (losses, [x.cpu() for x in
                                  tree_leaves(st["params"])])
        loss_err = max(abs(a - b) for a, b in zip(runs["cpu"][0],
                                                  runs["cuda"][0]))
        theta_err, flips = 0.0, 0.0
        for c, g in zip(runs["cpu"][1], runs["cuda"][1]):
            d = (c - g).abs()
            theta_err = max(theta_err, float(d.max()))
            flips = max(flips, float((d > 1e-4).float().mean()))
            if case == "full":
                check(float(d.max()) <= 1e-4,
                      f"{phase} {arch} {case}: theta {d.max()}")
            else:
                check(flips <= 5e-3 and float(d.max())
                      <= 1e-4 + 2 * float(c.abs().max()) / 127,
                      f"{phase} {arch} {case}: theta "
                      f"{float(d.max())}, flips {flips}")
        emit(phase, arch=arch, layers=cfg.num_layers, case=case,
             losses_cpu=runs["cpu"][0], losses_cuda=runs["cuda"][0],
             loss_max_abs_err=loss_err, theta_max_abs_err=theta_err,
             theta_flip_share=flips, prefix=prefix)
        check(loss_err <= 1e-4, f"{phase} {arch} {case}: loss err "
                                f"{loss_err}")


def phase_train_recurrent_parity(torch):
    """The recurrent families' smoke configs at 2 layers in f32 (zamba2:
    one Mamba2 layer and the shared attention block, attn_every 2;
    xlstm: one mLSTM and one sLSTM layer): 3 steps on the card (the
    SSD-scan kernel forward, the plain VJP backward) and on the CPU
    (the plain scan both ways) from one theta^0, losses and theta
    within 1e-4 (``_card_vs_cpu``)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops

    for arch, kw in (("zamba2-2.7b", dict(attn_every=2)),
                     ("xlstm-350m", dict(slstm_every=2))):
        cfg = dataclasses.replace(get_smoke_config(arch), num_layers=2,
                                  dtype="float32", **kw)
        ops.reset_launch_counts()
        _card_vs_cpu(torch, "train_recurrent_parity", cfg, ("full",))
        n = ops.launch_counts()["ssd_scan"]
        # 3 steps x 4 peers x 2 local steps x 2 microbatches, one scan
        # layer, forward and remat recompute
        check(n == 3 * 4 * 4 * 2, f"train_recurrent_parity {arch}: "
                                  f"{n} SSD-scan launches, expected 96")


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _mesh_state(torch, model, n_peers: int, mesh, cfg, device: str,
                rules: bool = True):
    """``init_fl_state`` from seed 0 as DTensors on ``mesh``: laid out by
    the sharding rules (peers over "data", TP over "model"), or with
    ``rules=False`` the peer dim split over "data" and nothing else
    (several peers a rank, which the rules give only with one peer a
    rank)."""
    from repro_torch.core.fl_device import init_fl_state
    from repro_torch.runtime.sharding import (NamedSharding, make_shard_plan,
                                              shard_tree, state_shardings)
    from repro_torch.tree import tree_map

    plain = init_fl_state(model, n_peers, seed=0, device=device)
    pm = {"params": plain["params"], "momentum": plain["momentum"]}
    if rules:
        sh = state_shardings(pm, make_shard_plan(mesh, ("data",)),
                             head_dim=cfg.head_dim, num_heads=cfg.num_heads,
                             num_kv_heads=cfg.num_kv_heads)
    else:
        sh = tree_map(lambda x: NamedSharding(
            mesh, ("data",) + (None,) * (x.dim() - 1)), pm)
    state = shard_tree(pm, sh)
    state["step"] = plain["step"]
    return state


def _train_mesh_full_width(torch, smi, record: dict) -> dict:
    """(a) and (c) of train_mesh on a one-rank NCCL world. Returns the
    flash launches of the TRAIN_MESH_STEPS steps."""
    import gc

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import topology
    from repro_torch.core.aggregation import CommLedger, build_pipeline
    from repro_torch.core.fl_device import make_fl_train_step
    from repro_torch.core.moshpit import plan_grid
    from repro_torch.data.synthetic import lm_token_stream
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import Model
    from repro_torch.runtime import roofline
    from repro_torch.runtime.op_analysis import OpAnalysis
    from repro_torch.tree import tree_leaves

    args = train._parser().parse_args(list(TRAIN_ARGS))
    cfg = get_config(args.arch)
    model = Model(cfg)
    n = args.peers
    grid = plan_grid(n)
    check(grid.dims == (2, 2), f"train_mesh: grid {grid.dims}")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"), device_type="cuda")
        pipeline = build_pipeline("mar", grid, backend="device")
        step = make_fl_train_step(model, grid, lr=args.lr,
                                  pipeline=pipeline)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = _mesh_state(torch, model, n, mesh, cfg, "cuda")
        leaf = tree_leaves(state["params"])[0]
        check(type(leaf).__name__ == "DTensor"
              and leaf.device_mesh is mesh, "train_mesh: not DTensors")
        stream = lm_token_stream(cfg.vocab_size, n * args.local_steps
                                 * args.batch, args.seq, seed=args.seed)
        ledger = CommLedger()
        peer_bytes = (topology.pytree_bytes(state["params"])
                      + topology.pytree_bytes(state["momentum"])) // n
        steps = []
        ops.reset_launch_counts()
        for t in range(TRAIN_MESH_STEPS):
            batch = {k: v.reshape(n, args.local_steps, 1, args.batch,
                                  args.seq) for k, v in next(stream).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            pipeline.record_iteration(ledger, n, peer_bytes)
            same = state_digests(torch, tree_leaves, state) \
                == record["digests"][t]
            steps.append({"step": t + 1, "loss": loss, "ms": ms,
                          "bit_equal_to_train": same})
            emit("train_mesh_step", **steps[-1])
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        med = statistics.median(st["ms"] for st in steps[1:])
        emit("train_mesh", what="(a) musicgen-medium, the train phase's "
             "traffic, state as DTensors on a one-rank NCCL DeviceMesh",
             mesh={"shape": list(mesh.shape),
                   "names": list(mesh.mesh_dim_names)},
             losses=[st["loss"] for st in steps],
             median_ms_steps_2_3=med, train_median_ms=record["median_ms"],
             launches=launches, comm_total_bytes=ledger.total_bytes,
             peak_memory_bytes=peak, peak_gb=peak / 1e9, card=smi)
        check(all(st["bit_equal_to_train"] for st in steps),
              "train_mesh (a): theta or m differ from the train phase's "
              f"after a step: {[st['bit_equal_to_train'] for st in steps]}")
        check(all(math.isfinite(st["loss"]) for st in steps),
              f"train_mesh (a): a loss is not finite: {steps}")
        check(launches["flash_attention"]
              == TRAIN_FLASH_PER_STEP * TRAIN_MESH_STEPS,
              f"train_mesh (a): {launches['flash_attention']} flash "
              f"launches, expected {TRAIN_FLASH_PER_STEP} a step")
        check(launches["mar_rounds"]
              == TRAIN_MAR_ROUNDS_PER_STEP * TRAIN_MESH_STEPS,
              f"train_mesh (a): {launches['mar_rounds']} mar_rounds "
              f"launches, expected {TRAIN_MAR_ROUNDS_PER_STEP} a step "
              f"(both rounds lie inside the one rank)")
        check(ledger.total_bytes == TRAIN_MESH_COMM_BYTES,
              f"train_mesh (a): ledger {ledger.total_bytes} != the "
              f"reference's {TRAIN_MESH_COMM_BYTES}")
        check(peak < TRAIN_MESH_PEAK_BYTES,
              f"train_mesh (a): peak {peak} bytes >= 80 GB")

        # (c): one more step, untimed, under the op analysis
        batch = {k: v.reshape(n, args.local_steps, 1, args.batch, args.seq)
                 for k, v in next(stream).items()}
        with OpAnalysis() as analysis:
            step(state, batch)
        torch.cuda.synchronize()
        args_bytes = sum(x.numel() * x.element_size() for x in
                         tree_leaves(state["params"])
                         + tree_leaves(state["momentum"]))
        shape = type("Shape", (), {"global_batch": n * args.batch,
                                   "seq_len": args.seq})
        rep = roofline.analyze(
            analysis.analyze(),
            roofline.memory_dict(args_bytes, peak - args_bytes),
            arch=args.arch, shape=f"train b={n * args.batch} s={args.seq}",
            mesh="one-rank-1x1", chips=1,
            model_flops=roofline.model_flops_estimate(cfg, shape, "train"))
        r = rep.to_dict()
        emit("train_mesh_roofline", what="(c) op_analysis of one more "
             "step of (a); H100 SXM5 datasheet peaks; the hand-written "
             "kernels (ctypes) are not counted",
             flops=r["hlo_flops_per_chip"], bytes=r["hlo_bytes_per_chip"],
             collective_bytes=r["collective_bytes_per_chip"],
             compute_s=r["compute_s"], memory_s=r["memory_s"],
             collective_s=r["collective_s"], dominant=r["dominant"],
             roofline_ms=r["step_time_s"] * 1e3, measured_ms=med,
             roofline_share=r["step_time_s"] * 1e3 / med,
             model_flops=r["model_flops"],
             useful_flops_fraction=r["useful_flops_fraction"],
             hbm_fraction=r["memory_per_chip"]["hbm_fraction"], card=smi)
        check(r["hlo_flops_per_chip"] > 0 and r["hlo_bytes_per_chip"] > 0,
              "train_mesh (c): the analysis counted nothing")
        del state, step, analysis
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _mesh_rank(rank: int, port: int, out_dir: str) -> None:
    """(b) of train_mesh, one of two ranks on the one card (gloo)."""
    import dataclasses
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=120))
    try:
        import numpy as np
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.configs import get_smoke_config
        from repro_torch.core import mar_allreduce as mar
        from repro_torch.core.fl_device import (init_fl_state,
                                                make_fl_train_step)
        from repro_torch.core.moshpit import plan_grid
        from repro_torch.models.model import Model
        from repro_torch.runtime.op_analysis import OpAnalysis
        from repro_torch.tree import tree_leaves

        torch.cuda.set_device(0)
        cfg = dataclasses.replace(get_smoke_config("musicgen-medium"),
                                  dtype="float32")
        model = Model(cfg)
        grid = plan_grid(4)
        mesh = DeviceMesh("cuda", torch.arange(2), mesh_dim_names=("data",))
        rng = np.random.default_rng(3)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (4, 1, 1, 2, 32)))
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, -1)}
        step = make_fl_train_step(model, grid, lr=0.05)
        ref, ref_m = step(init_fl_state(model, 4, seed=0, device="cuda"),
                          batch)
        state = _mesh_state(torch, model, 4, mesh, cfg, "cuda", rules=False)
        state, metrics = step(state, batch)
        first = mar.peer_layout(tree_leaves(state["params"])[0]).first
        err = {}
        for key in ("params", "momentum"):
            err[key] = max(float((x.to_local().float()
                                  - y[first:first + 2].float())
                                 .abs().max())
                           for x, y in zip(tree_leaves(state[key]),
                                           tree_leaves(ref[key])))
        agg = {"p": state["params"], "m": state["momentum"]}
        seen = {}
        for name, fn in (
                ("round0", lambda: mar.mar_round_device(agg, grid, 0)),
                ("round1", lambda: mar.mar_round_device(agg, grid, 1)),
                ("one_shot", lambda: mar.mar_aggregate_device(
                    agg, grid, one_shot=True))):
            with OpAnalysis() as a:
                fn()
            torch.cuda.synchronize()
            seen[name] = a.collectives
        out = {"rank": rank, "peers": [first, first + 2],
               "theta_err": err["params"], "m_err": err["momentum"],
               "loss": float(metrics["loss"]), "ref_loss": float(ref_m[
                   "loss"]), "collectives": seen,
               "local_shape": list(tree_leaves(
                   state["params"])[0].to_local().shape)}
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase_train_mesh(torch, smi, record: dict) -> dict:
    """train_mesh (a), (b) and (c); returns (a)'s launch counts."""
    import tempfile

    import torch.multiprocessing as mp

    launches = _train_mesh_full_width(torch, smi, record)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_mesh_rank, args=(_free_port(), tmp), nprocs=2, join=True)
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(2)]
    emit("train_mesh_two_ranks", what="(b) two processes on the one card "
         "over gloo, musicgen-medium smoke config in f32, 2 peers a rank "
         "on (2, 2); not a multi-card result", ranks=ranks,
         run_s=time.perf_counter() - t0, card=smi)
    for r in ranks:
        check(r["theta_err"] <= 1e-6 and r["m_err"] <= 1e-6,
              f"train_mesh (b) rank {r['rank']}: theta {r['theta_err']}, "
              f"m {r['m_err']} from the unsharded step")
        check(abs(r["loss"] - r["ref_loss"]) <= 1e-6,
              f"train_mesh (b) rank {r['rank']}: loss {r['loss']} vs "
              f"{r['ref_loss']}")
        sizes = {k: [(op, g) for op, _, g in v]
                 for k, v in r["collectives"].items()}
        check(sizes == {"round0": [("all-reduce", 2)], "round1": [],
                        "one_shot": [("all-reduce", 2)]},
              f"train_mesh (b) rank {r['rank']}: collectives {sizes}")
    return launches


def ptxas_summary(report: dict, sources) -> list:
    """Registers, spill bytes and static shared memory of every kernel
    the named sources compiled, read from nvcc's ``-Xptxas -v`` log
    (dynamic shared memory is set at launch: see the sources)."""
    import re
    import shutil

    demangle = shutil.which("c++filt")
    out, cur = [], None
    for src in sources:
        for ln in report.get(src, {}).get("log", "").splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                name = m.group(1)
                if demangle:
                    name = subprocess.run([demangle, name], text=True,
                                          capture_output=True).stdout
                    name = name.replace("(anonymous namespace)::", "")
                    name = name.strip().split("(")[0].removeprefix("void ")
                cur = {"source": src, "kernel": name}
                out.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                cur["spill_stores"] = int(m.group(1))
                cur["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", ln)
                cur["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def kernel_entry(name, source, replaces, launches, row):
    """One entry of the kernels line from a phase's path row."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                         else "operations"),
            "library_ms": row["library_ms"]}


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

    smi = smi_line()
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
    ptxas = ptxas_summary(report, ["group_mean", "flash_attention",
                                   "decode_attention", "ssd_scan",
                                   "mar_rounds"])
    emit("ptxas", kernels=ptxas)

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    # what the timing method reads for one near-empty kernel: the floor
    # under every small kernel's time below
    tiny = torch.zeros(8, device="cuda")
    emit("launch_floor", what="one 8-element add, as device_ms times it",
         ms=device_ms(torch, lambda: tiny.add_(1), flush=flush))
    phase_group_mean(torch, gm, ref, flush)
    round_rows = phase_group_mean_round(torch, flush)
    flash_rows = phase_flash(torch, flush)
    paged_rows = phase_paged(torch, flush)
    decode_rows = phase_decode(torch, flush)
    ssd_rows = phase_ssd_scan(torch, flush)
    phase_ssd_scan_grad(torch, flush)
    ssd_bwd_row = phase_ssd_scan_bwd(torch, flush, ptxas)
    mar_row = phase_mar_rounds(torch, flush)
    del flush
    phase_vision(torch)
    launches = phase_federation(torch, smi)
    launches += phase_federation_extensions(torch, smi)
    launches += phase_figures(torch, smi)
    launches += phase_federation_large_n(torch, smi)
    socket_launches, socket_trainer = phase_federation_socket(torch, smi)
    launches += socket_launches
    phase_profile(torch)
    serve_launches = phase_serve(torch, smi)
    phase_serve_parity(torch)
    recurrent_launches = phase_serve_recurrent(torch, smi)
    phase_recurrent_parity(torch)
    moe_launches = phase_serve_moe(torch, smi)
    phase_serve_moe_parity(torch)
    phase_checkpoint(torch)
    train_record = {}
    train_launches = phase_train(torch, smi, train_record)
    recurrent_train_launches = phase_train_recurrent(torch, smi)
    zamba2_launches = phase_train_zamba2(torch, smi)
    phase_train_parity(torch)
    phase_train_recurrent_parity(torch)
    mesh_launches = phase_train_mesh(torch, smi, train_record)

    # group_mean: the round row of the main path (the quickstart's theta
    # and m, N=27, round 0, one launch), its error the largest over the
    # three rounds, its launches those of the quickstart, of its
    # protocol-extension runs, of the smoke figures, of the large-N
    # runs and of the socket runs (kernel on); the attention kernels:
    # their first (bf16, serving-path) row; ssd_scan: its first (zamba2,
    # bf16) row. Launches: each path's count, read right after it ran,
    # summed over the paths a kernel lies on (flash: starcoder2, zamba2
    # and moonshot prefills, the musicgen, zamba2 and published Zamba2
    # training steps, the musicgen steps on a DTensor state (train_mesh)
    # and the in-process socket trainer's steps; paged: starcoder2 and
    # moonshot decode steps; ssd_scan: the zamba2 and xlstm prefills and
    # training steps and the published Zamba2's; ssd_scan_bwd: the
    # zamba2 training steps' and the published Zamba2's backward kernel
    # launches; mar_rounds: its phase's
    # row, the musicgen, zamba2, xlstm, published Zamba2 and train_mesh
    # (a) training steps and the in-process socket trainer's)
    qs = [r for r in round_rows if r["kind"] == "quickstart"]
    print(json.dumps({"kernels": [
        {**kernel_entry("group_mean",
                        "src/repro_torch/kernels/csrc/group_mean.cu",
                        "src/repro/kernels/group_mean.py:34", launches,
                        qs[0]),
         "max_abs_err": max(r["max_abs_err"] for r in qs),
         "row": "group_mean_round quickstart round 0"},
        kernel_entry("flash_attention",
                     "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:76",
                     serve_launches["flash_attention"]
                     + recurrent_launches["flash_attention"]
                     + moe_launches["flash_attention"]
                     + train_launches["flash_attention"]
                     + recurrent_train_launches["flash_attention"]
                     + zamba2_launches["flash_attention"]
                     + mesh_launches["flash_attention"]
                     + socket_trainer["flash_attention"],
                     flash_rows[0]),
        kernel_entry("paged_decode_attention",
                     "src/repro_torch/kernels/csrc/decode_attention.cu",
                     "src/repro/kernels/paged_attention.py:76",
                     serve_launches["paged_decode_attention"]
                     + moe_launches["paged_decode_attention"],
                     paged_rows[0]),
        kernel_entry("decode_attention",
                     "src/repro_torch/kernels/csrc/decode_attention.cu",
                     "src/repro/kernels/decode_attention.py:67",
                     serve_launches["decode_attention"]
                     + moe_launches["decode_attention"], decode_rows[0]),
        kernel_entry("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:70",
                     recurrent_launches["ssd_scan"]
                     + recurrent_train_launches["ssd_scan"]
                     + zamba2_launches["ssd_scan"], ssd_rows[0]),
        kernel_entry("ssd_scan_bwd",
                     "src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "none: the Pallas scan has no backward",
                     recurrent_train_launches["ssd_scan_bwd"]
                     + zamba2_launches["ssd_scan_bwd"], ssd_bwd_row),
        kernel_entry("mar_rounds",
                     "src/repro_torch/kernels/csrc/mar_rounds.cu",
                     "src/repro/core/mar_allreduce.py:166",
                     train_launches["mar_rounds"]
                     + recurrent_train_launches["mar_rounds"]
                     + zamba2_launches["mar_rounds"]
                     + mesh_launches["mar_rounds"]
                     + socket_trainer["mar_rounds"], mar_row),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
