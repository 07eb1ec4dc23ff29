"""Real TCP transport: the ``"socket"`` MessagePlan backend.

Where :class:`~repro_torch.runtime.network.NetworkSim` *models* a
:class:`~repro_torch.core.transport.MessagePlan`, this backend *executes* it:
every node of the plan (real peers and infrastructure ids alike) runs
as an asyncio task with its own TCP server, and every non-loopback
message becomes an actual framed ``send``/``recv`` between two of
those tasks. The per-round dependency semantics are the plan's
own — a node sends its round-``r`` messages once it has received all
its round-``r-1`` frames; there is no global barrier — so group
waits, ring hops, and hierarchy structure shape real wall-clock the
same way they shape simulated time.

Two deployment modes:

* **Single-process loopback** (the default, no address book): every
  node binds an ephemeral 127.0.0.1 port inside a private per-run
  event loop — the historical behavior, byte-exact vs the sim.
* **Multi-host address book** (``address_book=`` + ``rank=``): a
  config-driven :class:`AddressBook` fixes ``host:port`` per plan node
  and assigns each node an owning rank. Each rank runs only its own
  nodes' tasks, binds persistent servers on its nodes' fixed ports (a
  background event loop thread keeps them — and the outgoing
  connections — alive across iterations), and frames carry an
  iteration tag so a rank that races ahead buffers early frames
  instead of corrupting the previous run's accounting. Each rank's
  transcript bills exactly the events its nodes observe (receptions by
  owned nodes, plus owned loopbacks), so the per-rank transcripts are
  disjoint and :func:`merge_transcripts` reassembles the byte-exact
  whole — what ``python -m repro_torch.transport_calibration`` gates with a
  real two-process run (:func:`run_multiprocess`, spawn-based). A
  :class:`~repro_torch.core.replan.MembershipChange` rewires the book
  through ``Transport.resize``: node identity is positional, so
  survivors keep their fixed endpoints and a shrink simply stops
  scheduling the tail entries.

Transcript contract (the sim-vs-real calibration story, DESIGN.md §10):

* **Bytes are measured off received frame headers.** Each frame bills
  the plan's scheduled ``nbytes`` (carried as a float64 so fractional
  butterfly chunks round-trip exactly) and additionally moves a payload
  of ``ceil(nbytes)`` real octets, counted into ``payload_bytes``. A
  no-loss socket transcript is therefore *byte-identical* to the
  simulator's — same ``total_bytes``, ``bytes_by_round``,
  ``bytes_by_link`` — which
  ``repro_torch.transport_calibration`` asserts exactly.
* **Seconds are wall-clock**, not modeled: ``round_s`` stamps when the
  last frame of each round landed, ``peer_finish_s`` when each peer
  task completed its schedule. Reported, never asserted — loopback
  timing is the calibration *input*, not a claim.
* **Loss is injected, not suffered**: per-message Bernoulli at
  ``loss`` (seeded like the simulator's draw) and/or an explicit
  ``fail_sends={(round, src, dst), ...}`` set. A "lost" frame is still
  transmitted — flagged in its header so the receiver bills its
  airtime, counts it for round progression, but records it dropped and
  flags the sender — keeping ``demote_lost_senders`` semantics
  identical across backends without deadlocking the schedule.

Payloads are real update tensors: :func:`encode_state_payloads`
serializes each peer's stacked state leaves through the int8 absmax
wire format of ``core/compression.py`` (int8 codes + f32 scales), and
each frame's payload window cycles through the sender's blob. Peers
whose blob is shorter than their scheduled bytes pad with zeros;
infrastructure nodes (which own no model) always send zeros.

Port of the JAX package's ``repro/runtime/socket_transport.py``: the
same frame header, transcripts, loss draws and payload bytes.
:func:`encode_state_payloads` takes torch tensors on any device. In book
mode the port opens one connection per destination (the reference can
open two when two owned nodes send to one node at once, and leaves one
unclosed), and ``SocketTransport.close`` stops the inbound handlers
before it waits for the servers to close (see there);
:func:`run_multiprocess` stops waiting as soon as a rank dies.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import math
import socket as _socket
import struct
import threading
import time
from typing import (Any, Dict, List, Optional, Sequence, Set, Tuple,
                    Union)

import numpy as np

from repro_torch.core.transport import Message, MessagePlan
from repro_torch.runtime.transport_base import (Transcript, Transport,
                                                register_transport)

#: frame header: iteration tag, round, src, dst, billed nbytes (f64),
#: lost flag, payload length in real octets. The iteration tag lets a
#: multi-process rank that finished run k and raced into k+1 be
#: buffered by a peer still accounting run k.
_HEADER = struct.Struct("!IIIIdBI")
_READ_CHUNK = 1 << 20


# ---------------------------------------------------------------------------
# the address book (multi-host mode)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AddressBook:
    """Fixed ``(host, port)`` plus owning rank per plan node.

    Node identity is positional — entry ``i`` is plan node ``i`` (real
    peers first, then infrastructure ids) — which is what makes the
    elastic story work: a :class:`~repro_torch.core.replan.MembershipChange`
    that shrinks the fleet keeps survivors on their existing endpoints
    and simply stops scheduling the tail entries; growth past the book
    needs more entries (a config change, surfaced as a clear error).

    JSON form (``--peer-hosts`` in ``launch/train.py``)::

        {"nodes": [{"host": "10.0.0.1", "port": 9101, "rank": 0},
                   {"host": "10.0.0.2", "port": 9101, "rank": 1},
                   ...]}

    Entries may also be compact ``"host:port:rank"`` strings (rank
    defaults to 0 when omitted).
    """

    hosts: Tuple[str, ...]
    ports: Tuple[int, ...]
    ranks: Tuple[int, ...]

    def __post_init__(self):
        if not (len(self.hosts) == len(self.ports) == len(self.ranks)):
            raise ValueError("hosts/ports/ranks must align per node")

    @property
    def n_nodes(self) -> int:
        return len(self.hosts)

    @property
    def world_size(self) -> int:
        return max(self.ranks) + 1 if self.ranks else 0

    def owned(self, rank: int) -> Tuple[int, ...]:
        return tuple(i for i, r in enumerate(self.ranks) if r == rank)

    # -- (de)serialization ----------------------------------------------
    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "AddressBook":
        hosts, ports, ranks = [], [], []
        for entry in doc["nodes"]:
            if isinstance(entry, str):
                parts = entry.split(":")
                if len(parts) not in (2, 3):
                    raise ValueError(
                        f"node entry must be 'host:port[:rank]'; "
                        f"got {entry!r}")
                hosts.append(parts[0])
                ports.append(int(parts[1]))
                ranks.append(int(parts[2]) if len(parts) == 3 else 0)
            else:
                hosts.append(str(entry["host"]))
                ports.append(int(entry["port"]))
                ranks.append(int(entry.get("rank", 0)))
        return cls(tuple(hosts), tuple(ports), tuple(ranks))

    @classmethod
    def from_json(cls, path: str) -> "AddressBook":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        return {"nodes": [{"host": h, "port": p, "rank": r}
                          for h, p, r in zip(self.hosts, self.ports,
                                             self.ranks)]}

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    @classmethod
    def loopback(cls, n_nodes: int, world_size: int = 1,
                 host: str = "127.0.0.1") -> "AddressBook":
        """A local book: ``n_nodes`` distinct free ports on ``host``,
        nodes dealt round-robin over ``world_size`` ranks — the
        multi-process driver's default layout (mixing nodes across
        ranks exercises every cross-rank link)."""
        socks, ports = [], []
        for _ in range(n_nodes):
            s = _socket.socket()
            s.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
            s.bind((host, 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
        for s in socks:
            s.close()
        return cls(tuple(host for _ in range(n_nodes)), tuple(ports),
                   tuple(i % world_size for i in range(n_nodes)))


# ---------------------------------------------------------------------------
# per-run accounting
# ---------------------------------------------------------------------------

class _Collector:
    """Shared accounting for one run: receivers record every frame here
    (single event loop — no locking needed), peer tasks await their
    per-round arrival counts, and the transcript falls out at the end.

    With ``owned`` (multi-host mode) the collector accounts only the
    events this rank observes — frames received by owned nodes plus
    owned-node loopbacks — so per-rank transcripts are disjoint and sum
    to the single-process whole (:func:`merge_transcripts`)."""

    def __init__(self, plan: MessagePlan, n_nodes: int, n_real: int,
                 owned: Optional[Set[int]] = None):
        self.t0 = time.perf_counter()
        self.n_real = n_real
        n_rounds = len(plan.rounds)
        self.tr = Transcript(technique=plan.technique,
                             lost_senders=np.zeros(n_real, bool))
        self.tr.bytes_by_round = [0.0] * n_rounds
        self.tr.peer_finish_s = np.zeros(n_real)
        # all locally-billed events per round (loopbacks included) ->
        # round_s; a loopback bills at its sender, which owns both ends
        self.round_total = [
            sum(1 for m in msgs if owned is None or m.dst in owned)
            for msgs in plan.rounds]
        self.round_seen = [0] * n_rounds
        self.round_done_t = [0.0] * n_rounds
        # socket frames each owned node must receive per round
        # (loopbacks are billed at the sender and never hit the wire)
        self.expected = [[0] * n_nodes for _ in range(n_rounds)]
        for r, msgs in enumerate(plan.rounds):
            for m in msgs:
                if m.src != m.dst and (owned is None or m.dst in owned):
                    self.expected[r][m.dst] += 1
        self.seen = [[0] * n_nodes for _ in range(n_rounds)]
        self.events = [[asyncio.Event() for _ in range(n_nodes)]
                       for _ in range(n_rounds)]
        for r in range(n_rounds):
            for node in range(n_nodes):
                if not self.expected[r][node]:
                    self.events[r][node].set()

    def bill(self, rnd: int, src: int, dst: int, nbytes: float,
             lost: bool, payload_len: int = 0) -> None:
        """Account one frame (or loopback) exactly like the simulator's
        per-message billing: scheduled bytes, link/round split, drops."""
        tr = self.tr
        tr.n_messages += 1
        tr.total_bytes += nbytes
        tr.payload_bytes += payload_len
        tr.bytes_by_round[rnd] += nbytes
        key = (src, dst)
        tr.bytes_by_link[key] = tr.bytes_by_link.get(key, 0.0) + nbytes
        if lost:
            tr.dropped.append(Message(src, dst, nbytes))
            if src < self.n_real:
                tr.lost_senders[src] = True
        self.round_seen[rnd] += 1
        if self.round_seen[rnd] == self.round_total[rnd]:
            self.round_done_t[rnd] = time.perf_counter() - self.t0

    def arrived(self, rnd: int, dst: int) -> None:
        self.seen[rnd][dst] += 1
        if self.seen[rnd][dst] == self.expected[rnd][dst]:
            self.events[rnd][dst].set()

    async def wait_round(self, rnd: int, node: int) -> None:
        await self.events[rnd][node].wait()

    def finish(self) -> Transcript:
        tr = self.tr
        # round completion is monotone like the simulator's cumulative
        # ready times (late rounds can't finish before earlier ones)
        t = 0.0
        for rt in self.round_done_t:
            t = max(t, rt)
            tr.round_s.append(t)
        tr.iteration_s = time.perf_counter() - self.t0
        return tr


@register_transport
class SocketTransport(Transport):
    """Every plan node as an asyncio task over real TCP.

    ``run`` is synchronous at the call site (loopback mode owns a
    private event loop per iteration; book mode submits onto a
    persistent background loop), so the federation's per-step traffic
    path is backend-agnostic: ``transport.run(plan, payloads=...)``
    either simulates or really transmits.
    """

    name = "socket"
    wants_payloads = True

    def __init__(self, n_peers: int, seed: int = 0, loss: float = 0.0,
                 fail_sends: Optional[Set[Tuple[int, int, int]]] = None,
                 host: str = "127.0.0.1", timeout_s: float = 120.0,
                 address_book: Optional[AddressBook] = None,
                 rank: int = 0):
        self._n_peers = n_peers
        self.seed = seed
        self.loss = float(loss)
        self.fail_sends = set(fail_sends or ())
        self.host = host
        self.timeout_s = timeout_s
        self.book = address_book
        self.rank = int(rank)
        self.clock = 0.0           # cumulative wall-clock seconds
        self.iterations = 0
        # book mode: persistent loop thread + servers + writer cache;
        # frames that arrive for a run this rank hasn't started yet
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._servers: Dict[int, Any] = {}
        self._writers: Dict[int, asyncio.StreamWriter] = {}
        self._future: Dict[int, List[Tuple]] = {}
        self._connecting: Dict[int, asyncio.Lock] = {}
        self._active: Optional[Tuple[int, _Collector]] = None
        if address_book is not None and n_peers > address_book.n_nodes:
            raise ValueError(
                f"address book has {address_book.n_nodes} node "
                f"entries but the fleet has {n_peers} peers — extend "
                f"the book")

    @classmethod
    def from_config(cls, n_peers, *, profile=None, seed=0,
                    link_params=None,
                    address_book: Union[AddressBook, Dict, str,
                                        None] = None,
                    **kwargs):
        # loopback links are real — of the link knobs only the loss
        # rate survives, as deterministic send-failure injection
        loss = float((link_params or {}).get("loss", 0.0))
        if isinstance(address_book, str):
            address_book = AddressBook.from_json(address_book)
        elif isinstance(address_book, dict):
            address_book = AddressBook.from_dict(address_book)
        return cls(n_peers, seed=seed, loss=loss,
                   address_book=address_book, **kwargs)

    @property
    def n_peers(self) -> int:
        return self._n_peers

    @property
    def lossless(self) -> bool:
        return self.loss <= 0.0 and not self.fail_sends

    def resize(self, new_n: int) -> None:
        """Elastic membership: node identity is positional, so only the
        peer count moves; the cumulative clock carries over. In
        address-book mode this IS the rewiring — survivors keep their
        fixed endpoints, a shrink stops scheduling the tail entries,
        and growth past the book's entries raises (the book is config;
        extend it and relaunch the new ranks)."""
        if self.book is not None and new_n > self.book.n_nodes:
            raise ValueError(
                f"address book has {self.book.n_nodes} node entries; "
                f"cannot grow to {new_n} peers — extend the book "
                f"(--peer-hosts) and launch the new ranks")
        self._n_peers = new_n

    # ------------------------------------------------------------------
    def run(self, plan: MessagePlan,
            compute_s: Optional[np.ndarray] = None,
            payloads: Optional[Sequence[bytes]] = None) -> Transcript:
        """Execute one iteration's plan over real sockets.

        ``compute_s`` is ignored — this backend measures communication
        only; compute/straggler modeling stays with the lifecycle.
        ``payloads`` maps peer id -> serialized update blob
        (:func:`encode_state_payloads`); omitted peers send zeros.
        """
        if self.book is None:
            tr = asyncio.run(self._run(plan, payloads))
        else:
            tr = self._submit(self._run_book(plan, payloads))
        self._split_kd_bytes(tr, plan)
        self.clock += tr.iteration_s
        self.iterations += 1
        return tr

    def close(self) -> None:
        """Tear down book-mode servers/connections and the background
        loop (idempotent; loopback mode has nothing persistent)."""
        loop = self._loop
        if loop is None:
            return

        async def _shutdown():
            for w in self._writers.values():
                w.close()
            for srv in self._servers.values():
                srv.close()
            # the inbound handlers go first: since Python 3.12,
            # wait_closed() also waits for every connection the server
            # accepted, and a peer rank that has not closed yet still
            # holds its end of those open
            handlers = [t for t in asyncio.all_tasks()
                        if t is not asyncio.current_task()]
            for task in handlers:
                task.cancel()
            await asyncio.gather(*handlers, return_exceptions=True)
            for srv in self._servers.values():
                await srv.wait_closed()

        asyncio.run_coroutine_threadsafe(_shutdown(), loop).result(
            timeout=10)
        loop.call_soon_threadsafe(loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=10)
        loop.close()
        self._loop = None
        self._thread = None
        self._servers = {}
        self._writers = {}
        self._connecting = {}

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------------
    def _draw_losses(self, plan: MessagePlan) -> List[List[bool]]:
        """Per-message drop decisions, fixed before any task starts so
        the pattern is deterministic in (seed, iterations) regardless of
        socket scheduling — and identical across the ranks of a
        multi-process world, whose transports run in lockstep. The rng
        is seeded like the simulator's per-iteration stream, but the
        draws are NOT aligned with it: the sim draws per non-loopback
        message at the combined endpoint rate (infrastructure downlinks
        included), while this backend draws only for peer-sourced
        messages at the flat ``loss`` rate — same seed does not mean
        the same drop pattern across backends."""
        rng = np.random.default_rng(
            (self.seed + 1) * 48611 + self.iterations)
        out: List[List[bool]] = []
        for r, msgs in enumerate(plan.rounds):
            row = []
            for m in msgs:
                lost = False
                if m.src != m.dst and m.src < self._n_peers:
                    if self.loss > 0.0:
                        lost = bool(rng.random() < self.loss)
                    lost = lost or (r, m.src, m.dst) in self.fail_sends
                row.append(lost)
            out.append(row)
        return out

    def _payload_for(self, src: int, nbytes: float,
                     payloads: Optional[Sequence[bytes]]) -> bytes:
        size = int(math.ceil(nbytes))
        if size <= 0:
            return b""
        blob: bytes = b""
        if payloads is not None and src < self._n_peers:
            if isinstance(payloads, dict):
                blob = payloads.get(src, b"")
            elif src < len(payloads):
                blob = payloads[src]
        if not blob:
            return bytes(size)
        if len(blob) >= size:
            return blob[:size]
        reps = -(-size // len(blob))
        return (blob * reps)[:size]

    # ------------------------------------------------------------------
    # single-process loopback mode (private per-run event loop)
    # ------------------------------------------------------------------
    async def _run(self, plan: MessagePlan,
                   payloads: Optional[Sequence[bytes]]) -> Transcript:
        n_real = self._n_peers
        n_nodes = max(plan.n_nodes, n_real)
        col = _Collector(plan, n_nodes, n_real)
        losses = self._draw_losses(plan)
        it = self.iterations

        async def handler(reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
            try:
                while True:
                    hdr = await reader.readexactly(_HEADER.size)
                    _, rnd, src, dst, nbytes, lost, plen = \
                        _HEADER.unpack(hdr)
                    got = 0
                    while got < plen:           # really pull the octets
                        chunk = await reader.read(
                            min(plen - got, _READ_CHUNK))
                        if not chunk:
                            raise asyncio.IncompleteReadError(b"", plen)
                        got += len(chunk)
                    col.bill(rnd, src, dst, nbytes, bool(lost), plen)
                    col.arrived(rnd, dst)
            except (asyncio.IncompleteReadError, ConnectionResetError):
                pass                            # sender closed its link
            finally:
                writer.close()

        servers = []
        ports: List[int] = []
        for _ in range(n_nodes):
            srv = await asyncio.start_server(handler, self.host, 0)
            servers.append(srv)
            ports.append(srv.sockets[0].getsockname()[1])

        async def node_task(me: int) -> None:
            writers: Dict[int, asyncio.StreamWriter] = {}
            try:
                for r, msgs in enumerate(plan.rounds):
                    for seq, m in enumerate(msgs):
                        if m.src != me:
                            continue
                        if m.src == m.dst:      # loopback: billed, local
                            col.bill(r, m.src, m.dst, m.nbytes, False)
                            continue
                        w = writers.get(m.dst)
                        if w is None:
                            _, w = await asyncio.open_connection(
                                self.host, ports[m.dst])
                            writers[m.dst] = w
                        payload = self._payload_for(me, m.nbytes,
                                                    payloads)
                        w.write(_HEADER.pack(it, r, m.src, m.dst,
                                             float(m.nbytes),
                                             int(losses[r][seq]),
                                             len(payload)))
                        w.write(payload)
                        await w.drain()
                    await col.wait_round(r, me)
                if me < n_real:
                    col.tr.peer_finish_s[me] = \
                        time.perf_counter() - col.t0
            finally:
                for w in writers.values():
                    w.close()

        try:
            await asyncio.wait_for(
                asyncio.gather(*(node_task(i) for i in range(n_nodes))),
                timeout=self.timeout_s)
        except asyncio.TimeoutError:
            raise RuntimeError(
                f"socket transport stalled past {self.timeout_s}s "
                f"executing a {plan.technique!r} plan "
                f"({plan.n_messages} messages over {n_nodes} nodes)")
        finally:
            for srv in servers:
                srv.close()
            await asyncio.gather(*(s.wait_closed() for s in servers))

        return col.finish()

    # ------------------------------------------------------------------
    # multi-host address-book mode (persistent background loop)
    # ------------------------------------------------------------------
    def _ensure_loop(self) -> asyncio.AbstractEventLoop:
        if self._loop is None:
            self._loop = asyncio.new_event_loop()
            self._thread = threading.Thread(
                target=self._loop.run_forever,
                name=f"socket-transport-rank{self.rank}", daemon=True)
            self._thread.start()
        return self._loop

    def _submit(self, coro) -> Any:
        fut = asyncio.run_coroutine_threadsafe(coro, self._ensure_loop())
        return fut.result()

    async def _book_handler(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        """One per inbound connection, shared by every iteration the
        connection spans (senders keep connections open across runs)."""
        try:
            while True:
                hdr = await reader.readexactly(_HEADER.size)
                it, rnd, src, dst, nbytes, lost, plen = \
                    _HEADER.unpack(hdr)
                got = 0
                while got < plen:               # really pull the octets
                    chunk = await reader.read(
                        min(plen - got, _READ_CHUNK))
                    if not chunk:
                        raise asyncio.IncompleteReadError(b"", plen)
                    got += len(chunk)
                self._dispatch(it, rnd, src, dst, nbytes, bool(lost),
                               plen)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass                                # sender closed its link
        finally:
            try:
                writer.close()
            except RuntimeError:
                pass                            # loop already torn down

    def _dispatch(self, it: int, rnd: int, src: int, dst: int,
                  nbytes: float, lost: bool, plen: int) -> None:
        if self._active is not None and self._active[0] == it:
            col = self._active[1]
            col.bill(rnd, src, dst, nbytes, lost, plen)
            col.arrived(rnd, dst)
        elif it >= self.iterations:
            # a peer rank raced into a run this rank hasn't started:
            # buffer, drained when the matching run begins
            self._future.setdefault(it, []).append(
                (rnd, src, dst, nbytes, lost, plen))
        # frames for past iterations would be duplicates — drop

    async def _book_writer(self, dst: int) -> asyncio.StreamWriter:
        # two owned nodes may send to ``dst`` at once: one connects, the
        # other waits for that connection instead of opening a second
        # one (which the first would overwrite and leave unclosed)
        async with self._connecting.setdefault(dst, asyncio.Lock()):
            w = self._writers.get(dst)
            if w is None:
                w = self._writers[dst] = await self._book_connect(dst)
        return w

    async def _book_connect(self, dst: int) -> asyncio.StreamWriter:
        host, port = self.book.hosts[dst], self.book.ports[dst]
        deadline = time.perf_counter() + self.timeout_s
        delay = 0.02
        while True:
            try:
                _, w = await asyncio.open_connection(host, port)
                break
            except OSError:
                # the owning rank may still be starting up
                if time.perf_counter() >= deadline:
                    raise RuntimeError(
                        f"could not reach node {dst} at {host}:{port} "
                        f"within {self.timeout_s}s — is rank "
                        f"{self.book.ranks[dst]} running?")
                await asyncio.sleep(delay)
                delay = min(delay * 2, 0.5)
        return w

    async def _book_node_task(self, me: int, plan: MessagePlan,
                              losses: List[List[bool]],
                              payloads: Optional[Sequence[bytes]],
                              it: int, col: _Collector,
                              n_real: int) -> None:
        for r, msgs in enumerate(plan.rounds):
            for seq, m in enumerate(msgs):
                if m.src != me:
                    continue
                if m.src == m.dst:              # loopback: billed, local
                    col.bill(r, m.src, m.dst, m.nbytes, False)
                    continue
                w = await self._book_writer(m.dst)
                payload = self._payload_for(me, m.nbytes, payloads)
                w.write(_HEADER.pack(it, r, m.src, m.dst,
                                     float(m.nbytes),
                                     int(losses[r][seq]),
                                     len(payload)))
                w.write(payload)
                await w.drain()
            await col.wait_round(r, me)
        if me < n_real:
            col.tr.peer_finish_s[me] = time.perf_counter() - col.t0

    async def _run_book(self, plan: MessagePlan,
                        payloads: Optional[Sequence[bytes]]
                        ) -> Transcript:
        book = self.book
        n_real = self._n_peers
        n_nodes = max(plan.n_nodes, n_real)
        if n_nodes > book.n_nodes:
            raise ValueError(
                f"address book covers {book.n_nodes} nodes but the "
                f"{plan.technique!r} plan spans {n_nodes} — extend "
                f"the book")
        owned = {i for i in range(n_nodes)
                 if book.ranks[i] == self.rank}
        # bind owned nodes' servers once, on their fixed ports; they
        # persist across iterations (and across elastic resizes)
        for node in sorted(owned):
            if node not in self._servers:
                self._servers[node] = await asyncio.start_server(
                    self._book_handler, book.hosts[node],
                    book.ports[node])
        col = _Collector(plan, n_nodes, n_real, owned=owned)
        losses = self._draw_losses(plan)
        it = self.iterations
        self._active = (it, col)
        # frames that raced ahead of this run (no await between setting
        # _active and draining, so none can slip past both paths)
        for frame in self._future.pop(it, ()):
            col.bill(*frame[:3], frame[3], frame[4], frame[5])
            col.arrived(frame[0], frame[2])
        try:
            await asyncio.wait_for(
                asyncio.gather(*(
                    self._book_node_task(me, plan, losses, payloads,
                                         it, col, n_real)
                    for me in sorted(owned))),
                timeout=self.timeout_s)
        except asyncio.TimeoutError:
            raise RuntimeError(
                f"socket transport (rank {self.rank}) stalled past "
                f"{self.timeout_s}s executing a {plan.technique!r} "
                f"plan ({plan.n_messages} messages over {n_nodes} "
                f"nodes, {len(owned)} owned)")
        finally:
            self._active = None
        return col.finish()


# ---------------------------------------------------------------------------
# multi-process composition
# ---------------------------------------------------------------------------

def merge_transcripts(parts: Sequence[Transcript]) -> Transcript:
    """Reassemble one iteration's transcript from per-rank parts.

    Each rank bills a disjoint slice of the plan's events (receptions
    by its owned nodes + owned loopbacks), so byte fields *sum*; the
    time axes take elementwise maxima (a round completes when its last
    rank saw its last frame — ranks' clocks share only approximate
    epochs, and seconds are reported, never asserted); ``lost_senders``
    ORs and ``peer_finish_s`` takes each peer's owning rank's stamp.
    """
    parts = [p for p in parts if p is not None]
    if not parts:
        raise ValueError("no transcripts to merge")
    out = Transcript(technique=parts[0].technique)
    n_rounds = max(len(p.bytes_by_round) for p in parts)
    out.bytes_by_round = [0.0] * n_rounds
    out.round_s = [0.0] * n_rounds
    n_fin = max(len(p.peer_finish_s) for p in parts)
    out.peer_finish_s = np.zeros(n_fin)
    out.lost_senders = np.zeros(n_fin, bool)
    for p in parts:
        out.n_messages += p.n_messages
        out.total_bytes += p.total_bytes
        out.payload_bytes += p.payload_bytes
        out.kd_bytes += p.kd_bytes
        for r, b in enumerate(p.bytes_by_round):
            out.bytes_by_round[r] += b
        for r, s in enumerate(p.round_s):
            out.round_s[r] = max(out.round_s[r], s)
        for k, v in p.bytes_by_link.items():
            out.bytes_by_link[k] = out.bytes_by_link.get(k, 0.0) + v
        out.dropped.extend(p.dropped)
        ls = np.asarray(p.lost_senders, bool)
        out.lost_senders[:ls.size] |= ls
        pf = np.asarray(p.peer_finish_s, float)
        out.peer_finish_s[:pf.size] = np.maximum(
            out.peer_finish_s[:pf.size], pf)
        out.iteration_s = max(out.iteration_s, p.iteration_s)
    return out


def _mp_worker(rank: int, book_doc: Dict[str, Any], n_peers: int,
               plans: List[MessagePlan], seed: int, loss: float,
               timeout_s: float, queue) -> None:
    """One rank of the spawn-based world: runs every plan in sequence
    (iteration tags keep the ranks aligned) and ships its transcripts
    back through the queue. Top-level so the spawn context can pickle
    it."""
    transport = SocketTransport(
        n_peers, seed=seed, loss=loss, timeout_s=timeout_s,
        address_book=AddressBook.from_dict(book_doc), rank=rank)
    try:
        out = [transport.run(plan) for plan in plans]
        queue.put((rank, out))
    except BaseException as e:  # surface the failure, don't hang the parent
        queue.put((rank, RuntimeError(f"rank {rank}: {e!r}")))
    finally:
        transport.close()


def run_multiprocess(n_peers: int, plans: Sequence[MessagePlan], *,
                     world_size: int = 2, seed: int = 0,
                     loss: float = 0.0, host: str = "127.0.0.1",
                     timeout_s: float = 120.0,
                     book: Optional[AddressBook] = None
                     ) -> List[Transcript]:
    """Execute plans across ``world_size`` real OS processes.

    Builds a loopback :class:`AddressBook` over every node the plans
    span (round-robin rank assignment, so every cross-rank link is
    exercised), spawns one :class:`SocketTransport` rank per process
    (``spawn`` context — clean interpreters, the multi-host launch
    shape), runs the plan sequence in lockstep, and returns one
    *merged* transcript per plan — byte-exact vs the single-process
    backends, which ``repro_torch.transport_calibration`` gates.
    """
    import multiprocessing as mp
    from queue import Empty

    plans = list(plans)
    if not plans:
        return []
    n_nodes = max(max(p.n_nodes for p in plans), n_peers)
    if book is None:
        book = AddressBook.loopback(n_nodes, world_size=world_size,
                                    host=host)
    elif book.n_nodes < n_nodes:
        raise ValueError(f"address book covers {book.n_nodes} nodes, "
                         f"plans span {n_nodes}")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_mp_worker,
                         args=(r, book.to_dict(), n_peers, plans, seed,
                               loss, timeout_s, queue), daemon=True)
             for r in range(book.world_size)]
    for p in procs:
        p.start()
    results: Dict[int, List[Transcript]] = {}
    deadline = time.perf_counter() + timeout_s + 60
    try:
        while len(results) < len(procs):
            try:
                rank, out = queue.get(timeout=1.0)
            except Empty:
                # a worker that died before reporting (a failed spawn, a
                # crash) ends the wait at once, not at the deadline
                gone = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if gone or time.perf_counter() > deadline:
                    what = f"lost ranks {gone}" if gone else "timed out"
                    raise RuntimeError(
                        f"multi-process socket run {what}; worker exit "
                        f"codes: {[p.exitcode for p in procs]}")
                continue
            if isinstance(out, BaseException):
                raise out
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
    ranks = sorted(results)
    return [merge_transcripts([results[r][i] for r in ranks])
            for i in range(len(plans))]


# ---------------------------------------------------------------------------
# real-tensor payload serialization (int8 wire format)
# ---------------------------------------------------------------------------

def encode_state_payloads(state: Any) -> List[bytes]:
    """Serialize peer-stacked update tensors into per-peer wire blobs.

    Every leaf of ``state`` must carry peers on its leading axis. Each
    leaf is pushed through the int8 absmax quantizer of
    ``core/compression.py`` (the same wire format the Int8EF stage
    accounts for) on its own device, and each peer's blob concatenates
    its int8 codes plus the f32 scales, leaf by leaf in
    :func:`~repro_torch.tree.tree_leaves` order — the bytes a frame's
    payload window cycles through. The codes and scales of every leaf
    cross to the host in one copy.
    """
    import torch

    from repro_torch.core.compression import quantize_int8
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(state)
    if not leaves:
        return []
    n = int(leaves[0].shape[0])
    parts = []
    for leaf in leaves:
        q, scale = quantize_int8(leaf)
        parts.append(q.reshape(n, -1).view(torch.uint8))
        parts.append(scale.reshape(n, 1).view(torch.uint8))
    rows = torch.cat(parts, dim=1).cpu().numpy()
    return [row.tobytes() for row in rows]
