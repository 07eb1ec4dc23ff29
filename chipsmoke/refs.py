"""What the card gate holds the port to, as data: the reference's
numbers (the JAX package's, on the CPU, through
``tools/reference_constants.py``), the main paths' shapes and their
kernel launch counts, and two pure functions over them. Imports neither
torch nor jax, so the CPU tests and the tools read it as it is."""
from __future__ import annotations

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
#: name stems of the port's own kernels in a profiler trace
PORT_KERNELS = ("flash_fwd_", "decode_split_", "ssd_scan_", "ssd_bwd_",
                "group_mean_")
RECURRENT = dict(pad_len=512, max_new=32, sessions=4)
#: per prefill: (ssd_scan launches, flash launches) of the published models
RECURRENT_LAUNCHES = {"zamba2-2.7b": (45, 9), "xlstm-350m": (21, 0)}


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
