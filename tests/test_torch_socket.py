"""The port's socket transport (``runtime/socket_transport.py``) on the
CPU: real asyncio tasks over loopback TCP, against the port's simulator
and the reference's own socket transport.

* ``AddressBook`` reads and writes the reference's JSON form.
* Loopback transcripts are byte-exact against the port's ``"sim"`` for
  every technique at 8 and 27 peers, and under churn masks (the cases
  of the reference's ``tests/test_transport.py``).
* The Bernoulli loss draws and injected send failures flag the
  reference's senders; ``encode_state_payloads`` gives the reference's
  bytes for f32 and bf16 leaves.
* Book mode: two ranks in one process merge byte-exact against the sim
  (the reference test's four assertions), then close in either order
  within 5 s; growth past the book raises; two spawned processes
  (``run_multiprocess``) merge byte-exact too.

Every wait is bounded: ``timeout_s`` on the transports, timeouts on the
futures and on the closes.
"""
import gc
import re
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregation import make_aggregator as ref_make_aggregator
from repro.core.moshpit import plan_grid as ref_plan_grid
from repro.runtime import socket_transport as ref_socket

from repro_torch.core.aggregation import TECHNIQUES, make_aggregator
from repro_torch.core.moshpit import plan_grid
from repro_torch.core.transport import build_message_plan
from repro_torch.runtime.network import NetworkSim
from repro_torch.runtime.socket_transport import (AddressBook,
                                                  SocketTransport,
                                                  encode_state_payloads,
                                                  merge_transcripts,
                                                  run_multiprocess)
from repro_torch.runtime.transport_base import demote_lost_senders

MB = 10_000   # state bytes per transfer (integral -> float sums exact)
TIMEOUT_S = 30.0


def _plan(tech, n, mask=None):
    mask = np.ones(n, np.float32) if mask is None else mask
    return make_aggregator(tech, plan_grid(n)).message_plan(mask, MB)


def _sock(n, **kw):
    return SocketTransport(n, timeout_s=TIMEOUT_S, **kw)


def _same_bytes(got, want):
    assert got.total_bytes == want.total_bytes
    assert got.bytes_by_round == want.bytes_by_round
    assert got.bytes_by_link == want.bytes_by_link
    assert got.n_messages == want.n_messages


# ---------------------------------------------------------------------------
# the address book
# ---------------------------------------------------------------------------

def test_address_book_round_trips_in_the_references_form(tmp_path):
    book = AddressBook(hosts=("10.0.0.1", "10.0.0.2", "10.0.0.3"),
                       ports=(9101, 9101, 9102), ranks=(0, 1, 1))
    ref = ref_socket.AddressBook(book.hosts, book.ports, book.ranks)
    assert book.to_dict() == ref.to_dict()
    path = tmp_path / "book.json"
    book.to_json(str(path))
    assert AddressBook.from_json(str(path)) == book
    assert ref_socket.AddressBook.from_json(str(path)) == ref
    doc = {"nodes": ["10.0.0.1:9101:0", "10.0.0.2:9101",
                     {"host": "h", "port": 7}]}
    got = AddressBook.from_dict(doc)
    assert got.to_dict() == ref_socket.AddressBook.from_dict(doc).to_dict()
    assert got.ranks == (0, 0, 0)
    assert book.world_size == 2 and book.owned(1) == (1, 2)
    assert book.n_nodes == 3
    with pytest.raises(ValueError, match="host:port"):
        AddressBook.from_dict({"nodes": ["justahost"]})
    with pytest.raises(ValueError, match="align"):
        AddressBook(("a",), (1, 2), (0,))
    lb = AddressBook.loopback(5, world_size=2)
    assert lb.ranks == (0, 1, 0, 1, 0) and len(set(lb.ports)) == 5
    assert set(lb.hosts) == {"127.0.0.1"}


# ---------------------------------------------------------------------------
# loopback: byte-exact against the sim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 27])
@pytest.mark.parametrize("tech", sorted(TECHNIQUES))
def test_loopback_is_byte_exact_vs_sim(tech, n):
    mplan = _plan(tech, n)
    sim = NetworkSim(n, profile="uniform", seed=0).run(mplan)
    sock = _sock(n).run(mplan)
    _same_bytes(sock, sim)
    assert sock.n_dropped == 0 and not sock.lost_senders.any()
    assert len(sock.round_s) == len(sim.round_s)
    assert sock.peer_finish_s.shape == sim.peer_finish_s.shape
    assert sock.iteration_s > 0.0
    # the socket really moved the scheduled octets
    assert sock.payload_bytes == sum(
        int(np.ceil(m.nbytes)) for r in mplan.rounds for m in r
        if m.src != m.dst)


@pytest.mark.parametrize("tech", ["mar", "hierarchical", "rdfl"])
def test_loopback_is_byte_exact_vs_sim_under_churn(tech):
    for seed in range(4):
        mask = (np.random.default_rng(seed).random(8) < 0.6
                ).astype(np.float32)
        mplan = _plan(tech, 8, mask)
        _same_bytes(_sock(8).run(mplan),
                    NetworkSim(8, profile="uniform", seed=0).run(mplan))


def test_payloads_carry_real_tensors():
    state = {"w": torch.arange(4 * 32, dtype=torch.float32).reshape(4, 32),
             "b": torch.ones(4, 3)}
    blobs = encode_state_payloads(state)
    # int8 codes + one f32 scale per leaf per peer
    assert [len(b) for b in blobs] == [32 + 4 + 3 + 4] * 4
    mplan = _plan("mar", 4)
    tr = _sock(4).run(mplan, payloads=blobs)
    assert tr.total_bytes == mplan.total_bytes and tr.payload_bytes > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_payload_blobs_are_the_references(dtype):
    rng = np.random.default_rng(3)
    tree = {"fc2": {"w": rng.normal(size=(5, 7, 3)),
                    "b": rng.normal(size=(5, 3))},
            "fc1": {"w": 40 * rng.normal(size=(5, 11))},
            "scalar": rng.normal(size=(5,))}

    def build(fn, t=tree):
        return {k: build(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in t.items()}

    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    port = build(lambda x: torch.from_numpy(x.astype(np.float32)).to(tdt))
    # a non-contiguous leaf: the bytes follow the logical order
    port["fc1"]["w"] = torch.from_numpy(
        40 * rng.normal(size=(11, 5)).astype(np.float32)).T.to(tdt)
    ref = build(lambda x: jnp.asarray(x.astype(np.float32), jdt))
    ref["fc1"]["w"] = jnp.asarray(port["fc1"]["w"].float().numpy(), jdt)
    assert encode_state_payloads(port) == ref_socket.encode_state_payloads(
        ref)
    assert encode_state_payloads({}) == []


# ---------------------------------------------------------------------------
# loss: injected, deterministic in (seed, iterations), as the reference's
# ---------------------------------------------------------------------------

def test_bernoulli_loss_flags_the_references_senders():
    mplan = _plan("mar", 8)
    ref_mplan = ref_make_aggregator("mar", ref_plan_grid(8)).message_plan(
        np.ones(8, np.float32), MB)
    port = _sock(8, seed=2, loss=0.5)
    ref = ref_socket.SocketTransport(8, seed=2, loss=0.5,
                                     timeout_s=TIMEOUT_S)
    assert not port.lossless
    for _ in range(3):             # the stream moves with the iteration
        got, want = port.run(mplan), ref.run(ref_mplan)
        assert got.n_dropped > 0
        np.testing.assert_array_equal(got.lost_senders, want.lost_senders)
        assert (sorted((m.src, m.dst) for m in got.dropped)
                == sorted((m.src, m.dst) for m in want.dropped))
        assert ({m.src for m in got.dropped}
                == set(np.flatnonzero(got.lost_senders)))
        # lost frames consumed airtime: billed like the simulator
        assert got.total_bytes == mplan.total_bytes


def test_injected_failure_demotes_the_sender_to_receiver_only():
    mplan = _plan("mar", 8)
    victim = mplan.rounds[0][0]
    st = _sock(8, fail_sends={(0, victim.src, victim.dst)})
    assert not st.lossless and _sock(8).lossless
    tr = st.run(mplan)
    assert [(m.src, m.dst) for m in tr.dropped] == \
        [(victim.src, victim.dst)]
    assert tr.total_bytes == mplan.total_bytes
    u = np.ones(8, np.float32)
    a = demote_lost_senders(u.copy(), u, tr)
    assert a[victim.src] == 0.0 and a.sum() == 7


def test_from_config_keeps_only_the_loss_rate():
    sock = SocketTransport.from_config(8, profile="wireless", seed=3,
                                       link_params={"loss": 0.25})
    assert sock.name == "socket" and sock.loss == 0.25
    assert sock.wants_payloads and not sock.lossless
    sock.resize(6)
    assert sock.n_peers == 6


# ---------------------------------------------------------------------------
# book mode and processes
# ---------------------------------------------------------------------------

def _close_within(transport, seconds):
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as ex:
        ex.submit(transport.close).result(timeout=seconds)
    assert time.perf_counter() - t0 <= seconds
    transport.close()                      # idempotent


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_two_rank_book_byte_exact_vs_sim_and_closes(order):
    """Two ranks (own event loops, cross-rank TCP on fixed book ports)
    merge byte-exact against the sim, then close in ``order`` without
    waiting on the other rank: each close stops its inbound handlers
    before it waits for its servers."""
    n = 4
    grid = plan_grid(n)
    plans = [build_message_plan(t, grid, None, 1000.0)
             for t in ("mar", "ar", "fedavg")]
    n_nodes = max(max(p.n_nodes for p in plans), n)
    book = AddressBook.loopback(n_nodes, world_size=2)
    ranks = [_sock(n, address_book=book, rank=r) for r in (0, 1)]
    sim = NetworkSim.from_config(n, profile="uniform", seed=0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", ResourceWarning)
        try:
            for p in plans:
                with ThreadPoolExecutor(2) as ex:
                    parts = [ex.submit(t.run, p) for t in ranks]
                    merged = merge_transcripts(
                        [f.result(timeout=TIMEOUT_S) for f in parts])
                ref = sim.run(p)
                assert merged.total_bytes == ref.total_bytes
                assert merged.bytes_by_round == ref.bytes_by_round
                assert merged.bytes_by_link == ref.bytes_by_link
                assert merged.n_messages == ref.n_messages
        finally:
            for r in order:
                _close_within(ranks[r], 5.0)
        gc.collect()
    assert all(t._loop is None and t._servers == {} for t in ranks)
    # one connection a destination: none opened twice and dropped open
    assert not [w for w in caught if w.category is ResourceWarning]


def test_book_rejects_growth_past_its_entries():
    book = AddressBook.loopback(4, world_size=1)
    t = _sock(4, address_book=book, rank=0)
    t.resize(3)               # shrink: survivors keep their endpoints
    assert t.n_peers == 3
    with pytest.raises(ValueError, match="extend the book"):
        t.resize(5)
    with pytest.raises(ValueError, match="extend"):
        _sock(6, address_book=book, rank=0)
    small = AddressBook.loopback(2, world_size=1)
    t = _sock(2, address_book=small, rank=0)
    try:
        with pytest.raises(ValueError, match="extend"):
            t.run(build_message_plan("fedavg", plan_grid(2), None, 10.0))
    finally:
        _close_within(t, 5.0)


def test_run_multiprocess_merges_byte_exact_vs_sim():
    n = 4
    grid = plan_grid(n)
    plans = [build_message_plan(t, grid, None, float(MB))
             for t in ("mar", "ar", "fedavg")]
    merged = run_multiprocess(n, plans, world_size=2, timeout_s=TIMEOUT_S)
    sim = NetworkSim(n, profile="uniform", seed=0)
    assert len(merged) == len(plans)
    for p, got in zip(plans, merged):
        _same_bytes(got, sim.run(p))
        assert got.n_dropped == 0
    assert run_multiprocess(n, []) == []


def test_transport_calibration_prints_the_references_rows(monkeypatch,
                                                          capsys):
    """``python -m repro_torch.transport_calibration --smoke`` against
    ``benchmarks/transport_calibration.py --smoke``: the same rows, key
    for key, every byte count equal and byte-exact; only the seconds
    differ."""
    from pathlib import Path

    from repro_torch import transport_calibration

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    from benchmarks import transport_calibration as ref_calibration

    def rows():
        return [re.sub(r",(sim_s|wall_s|wall_over_sim)=[^,]*", "", line)
                for line in capsys.readouterr().out.splitlines()]

    assert transport_calibration.main(["--smoke", "--device", "cpu"]) == 0
    got = rows()
    assert ref_calibration.main(["--smoke"]) == 0
    assert got == rows()
    assert got[-1].endswith("byte_mismatches=0")
    assert sum("byte_exact=True" in line for line in got) == len(got) - 1
