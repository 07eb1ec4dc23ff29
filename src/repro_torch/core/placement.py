"""Topology-aware grid placement: align MAR groups to the network.

``plan_grid`` assigns grid coordinates by raw peer index, so on
structured-heterogeneous links (the ``regions`` profile's WAN-separated
blocks) every one of the d aggregation rounds pays cross-region
bandwidth caps and latency. The cluster-FL literature (PAPERS.md: CFL;
SNIPPETS.md Snippet 1's location-clustered D2D hierarchy, ~76% traffic
reduction from locality alone) shows the next constant factor lives in
*who groups with whom*. This module learns that from measured link
evidence and expresses it as a peer→slot permutation on
:class:`~repro_torch.core.moshpit.GridPlan`:

* :class:`LinkQualityEstimator` — accumulates per-link seconds-per-byte
  from transcripts: ``Transcript.link_time_stats`` when the engines
  measured it, else derived from ``bytes_by_link`` + ``peer_finish_s``
  (a sender's finish time apportioned over its outgoing links by byte
  share).
* :class:`ClusteredPlacement` — regular MAR transcripts only ever cover
  each peer's ~d·(M-1) grid partners, so when accumulated evidence is
  too sparse the policy falls back to landmark probe rounds (tiny
  broadcast/gather messages through the *live* transport via
  :meth:`PlacementPolicy.bind_prober`), k-means-clusters peers on their
  log cost-to-landmark rows, and packs each cluster into contiguous
  slots. Contiguous low-axis packing means cross-cluster traffic lands
  in the *high* coordinate axes — exactly one of the d rounds for
  cluster counts ≤ dims[0] — the same trick ``mesh_grid_plan`` plays
  with the pod axis (DESIGN.md §2).
* a registry (``identity`` / ``random`` / ``clustered``) mirroring
  ``core/adaptive.py``'s controllers: policies observe each iteration's
  transcript and propose a full :class:`GridPlan` (same dims, new
  ``placement``) that ``Federation.regroup`` applies as a
  membership-preserving regroup — composing with the
  ``GroupSizeController`` (placement re-emitted via :meth:`rebind`
  after an adaptive-M dims change or an elastic resize).

Placement changes *when* traffic crosses the WAN, never *how much*:
any permutation preserves per-round byte totals
(``topology.mar_bytes`` stays the oracle — asserted in
``tests/test_placement.py`` and ``benchmarks/placement.py``).

A copy of the JAX package's ``repro/core/placement.py`` (numpy) with its imports
rewritten; tests hold it equal to the reference.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Type

import numpy as np

from repro_torch.core.moshpit import GridPlan
from repro_torch.core.transport import Message, MessagePlan

__all__ = ["PLACEMENTS", "PlacementPolicy", "IdentityPlacement",
           "RandomPlacement", "ClusteredPlacement",
           "LinkQualityEstimator", "build_placement",
           "cluster_permutation", "probe_plan", "register_placement"]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

PLACEMENTS: Dict[str, Type["PlacementPolicy"]] = {}


def register_placement(cls: Type["PlacementPolicy"]
                       ) -> Type["PlacementPolicy"]:
    PLACEMENTS[cls.name] = cls
    return cls


def build_placement(name: str, plan: GridPlan, seed: int = 0,
                    **params: Any) -> "PlacementPolicy":
    if name not in PLACEMENTS:
        raise ValueError(f"unknown placement policy {name!r}; "
                         f"registered: {sorted(PLACEMENTS)}")
    return PLACEMENTS[name](plan, seed=seed, **params)


# ---------------------------------------------------------------------------
# link-quality evidence
# ---------------------------------------------------------------------------

class LinkQualityEstimator:
    """Per-link seconds-per-byte accumulated across transcripts.

    Evidence order of preference, per transcript: measured
    ``link_time_stats`` (the modeled engines fill it exactly); else a
    derivation from ``bytes_by_link`` + ``peer_finish_s`` — each
    sender's finish time apportioned over its outgoing links by byte
    share (an upper-bound effective time that preserves the *ordering*
    of slow vs fast destinations a sender saw, which is all clustering
    needs). Loopbacks and infrastructure endpoints carry no link
    information and are skipped.
    """

    def __init__(self, n_peers: int):
        self.n_peers = n_peers
        self._secs: Dict[Tuple[int, int], float] = {}
        self._bytes: Dict[Tuple[int, int], float] = {}
        self._baseline: Dict[Tuple[int, int], float] = {}

    @property
    def n_links(self) -> int:
        return len(self._bytes)

    def _add(self, key: Tuple[int, int], secs: float,
             nbytes: float) -> None:
        self._secs[key] = self._secs.get(key, 0.0) + secs
        self._bytes[key] = self._bytes.get(key, 0.0) + nbytes

    def update(self, transcript: Any) -> None:
        n = self.n_peers
        stats = getattr(transcript, "link_time_stats", None) or {}
        if stats:
            for (s, d), sec in stats.items():
                if s < n and d < n and s != d:
                    b = transcript.bytes_by_link.get((s, d), 0.0)
                    if b > 0:
                        self._add((s, d), sec, b)
            return
        links = getattr(transcript, "bytes_by_link", None) or {}
        fin = np.asarray(getattr(transcript, "peer_finish_s",
                                 np.zeros(0)), float)
        out_bytes: Dict[int, float] = {}
        for (s, d), b in links.items():
            if s < n and s != d:
                out_bytes[s] = out_bytes.get(s, 0.0) + b
        for (s, d), b in links.items():
            if (s < n and d < n and s != d and b > 0
                    and s < fin.size and out_bytes[s] > 0):
                self._add((s, d), fin[s] * (b / out_bytes[s]), b)

    def cost_to(self, landmarks: np.ndarray) -> np.ndarray:
        """[n_peers, len(landmarks)] seconds-per-byte to/from each
        landmark (mean of the two directions where both are observed);
        NaN where no evidence exists. A landmark's own row entry is
        NaN (no self-link) — callers impute."""
        n, lm = self.n_peers, np.asarray(landmarks)
        out = np.full((n, lm.size), np.nan)
        for j, l in enumerate(lm.tolist()):
            for i in range(n):
                if i == l:
                    continue
                vals = []
                for key in ((l, i), (i, l)):
                    b = self._bytes.get(key, 0.0)
                    if b > 0:
                        vals.append(self._secs[key] / b)
                if vals:
                    out[i, j] = float(np.mean(vals))
        return out

    def coverage(self, landmarks: np.ndarray) -> float:
        """Fraction of (peer, landmark) pairs with any evidence."""
        c = self.cost_to(landmarks)
        lm = np.asarray(landmarks)
        mask = np.ones((self.n_peers, lm.size), bool)
        mask[lm, np.arange(lm.size)] = False      # self entries
        denom = int(mask.sum())
        return float(np.isfinite(c[mask]).sum()) / denom if denom \
            else 0.0

    def rates(self) -> Dict[Tuple[int, int], float]:
        """Current per-link seconds-per-byte estimates."""
        return {k: self._secs[k] / b
                for k, b in self._bytes.items() if b > 0}

    def mark(self) -> None:
        """Snapshot current rates as the drift baseline — call when a
        clustering was produced from (and therefore reflects) them."""
        self._baseline = self.rates()

    def drift(self) -> float:
        """Median relative change in per-link seconds-per-byte since
        the last :meth:`mark` (0.0 without a baseline or overlap).

        The statistic clustered placement watches between scheduled
        re-cluster ticks: link quality moving by, say, 2x on half the
        observed links means the permutation was computed for a
        network that no longer exists. Median, not max — one link
        blipping shouldn't trigger a fleet-wide regroup."""
        if not self._baseline:
            return 0.0
        cur = self.rates()
        rel = [abs(cur[k] - v) / v
               for k, v in self._baseline.items()
               if k in cur and v > 0]
        return float(np.median(rel)) if rel else 0.0

    def resize(self, new_n: int) -> None:
        """Elastic membership invalidates link identities past the
        survivor range; drop evidence touching departed peers."""
        if new_n < self.n_peers:
            self._secs = {k: v for k, v in self._secs.items()
                          if k[0] < new_n and k[1] < new_n}
            self._bytes = {k: v for k, v in self._bytes.items()
                           if k[0] < new_n and k[1] < new_n}
            self._baseline = {k: v for k, v in self._baseline.items()
                              if k[0] < new_n and k[1] < new_n}
        self.n_peers = new_n


def probe_plan(n_peers: int, landmarks: np.ndarray,
               probe_bytes: float = 250_000.0) -> MessagePlan:
    """Landmark broadcast/gather probe rounds.

    Two rounds per landmark — landmark→all then all→landmark — give a
    complete [n_peers, landmarks] cost matrix in both directions from
    one plan. Probe messages ride the live transport, so their
    ``link_time_stats`` reflect whatever the real links do; the modeled
    engines bill seconds even for lost messages, so loss cannot blind
    the estimator.
    """
    rounds: List[Tuple[Message, ...]] = []
    for l in np.asarray(landmarks).tolist():
        rounds.append(tuple(Message(int(l), i, float(probe_bytes))
                            for i in range(n_peers) if i != l))
        rounds.append(tuple(Message(i, int(l), float(probe_bytes))
                            for i in range(n_peers) if i != l))
    return MessagePlan("placement_probe", n_peers, n_peers,
                       tuple(rounds))


# ---------------------------------------------------------------------------
# clustering (pure numpy — no sklearn in the image)
# ---------------------------------------------------------------------------

def _kmeans(X: np.ndarray, k: int, seed: int,
            iters: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded k-means++ returning (labels, centers)."""
    rng = np.random.default_rng(seed * 7919 + k)
    n = X.shape[0]
    centers = [X[int(rng.integers(n))]]
    for _ in range(1, k):
        d2 = np.min(np.stack([((X - c) ** 2).sum(-1)
                              for c in centers]), axis=0)
        tot = d2.sum()
        pick = (int(rng.integers(n)) if tot <= 0
                else int(rng.choice(n, p=d2 / tot)))
        centers.append(X[pick])
    C = np.stack(centers)
    labels = np.full(n, -1, np.int64)
    for _ in range(iters):
        d = ((X[:, None, :] - C[None]) ** 2).sum(-1)
        new = d.argmin(1)
        if np.array_equal(new, labels):
            break
        labels = new
        for j in range(k):
            m = labels == j
            if m.any():
                C[j] = X[m].mean(0)
    return labels, C


def _silhouette(X: np.ndarray, labels: np.ndarray,
                C: np.ndarray) -> float:
    """Simplified (centroid-based) silhouette — enough to pick k.
    Only live (non-empty) clusters' centers count: a stale empty
    center sits on a data point and would poison ``other``."""
    live = np.unique(labels)
    d = np.sqrt(((X[:, None, :] - C[None, live]) ** 2).sum(-1))
    pos = np.searchsorted(live, labels)
    own = d[np.arange(X.shape[0]), pos]
    d_masked = d.copy()
    d_masked[np.arange(X.shape[0]), pos] = np.inf
    other = d_masked.min(1)
    denom = np.maximum(np.maximum(own, other), 1e-300)
    return float(np.mean((other - own) / denom))


def cluster_labels(features: np.ndarray, k: Optional[int] = None,
                   seed: int = 0, k_max: int = 8) -> np.ndarray:
    """Cluster peers on their feature rows; auto-k by silhouette when
    ``k`` is None. Labels are renumbered by first appearance so equal
    evidence always yields identical labels (stability under the
    re-cluster cadence)."""
    n = features.shape[0]
    if k is not None:
        labels, _ = _kmeans(features, min(k, n), seed)
    else:
        best, labels = -np.inf, np.zeros(n, np.int64)
        for kk in range(2, min(k_max, n - 1) + 1):
            cand, C = _kmeans(features, kk, seed)
            if np.unique(cand).size < 2:
                continue
            score = _silhouette(features, cand, C)
            if score > best:
                best, labels = score, cand
    # renumber by first appearance
    remap: Dict[int, int] = {}
    out = np.empty(n, np.int64)
    for i, c in enumerate(labels.tolist()):
        out[i] = remap.setdefault(c, len(remap))
    return out


def cluster_permutation(labels: np.ndarray,
                        capacity: Optional[int] = None,
                        align: Optional[int] = None) -> np.ndarray:
    """peer→slot: clusters pack contiguous slot ranges, largest
    cluster first (ties broken by lowest member index); within a
    cluster peers keep relative order.

    Largest-first matters on mixed-radix grids: equal-size clusters
    land on aligned sub-block boundaries and any remainder cluster
    packs last against the virtual-slot tail, so a stray small cluster
    cannot shift every later cluster off its block boundary (which
    would re-mix regions inside low-axis blocks and forfeit the
    placement win). Stable: re-clustering to the same labels is the
    identity update.

    With ``capacity`` (> n_peers) the returned permutation covers the
    whole grid, assigning the virtual entities explicitly instead of
    leaving :meth:`GridPlan.with_placement` to fill leftover slots
    blindly: each cluster is padded with virtuals up to the next
    multiple of ``align`` (the grid's sub-block size) while spare
    capacity lasts, so a churn-shrunk cluster absorbs its own padding
    rather than pulling the next cluster across a sub-block boundary.
    Remaining virtuals fill the tail. ``capacity=None`` (the default)
    is the historical peer-only permutation, bit-for-bit."""
    labels = np.asarray(labels)
    n = labels.size
    cap = n if capacity is None else int(capacity)
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} peers")
    perm = np.empty(cap, np.int64)
    order = sorted(
        np.unique(labels).tolist(),
        key=lambda c: (-int((labels == c).sum()),
                       int(np.flatnonzero(labels == c)[0])))
    slot = 0
    virt = n                      # next virtual entity id
    for c in order:
        members = np.flatnonzero(labels == c)
        perm[members] = np.arange(slot, slot + members.size)
        slot += members.size
        if align and align > 1 and virt < cap:
            pad = min((-slot) % align, cap - virt)
            if pad:
                perm[virt:virt + pad] = np.arange(slot, slot + pad)
                virt += pad
                slot += pad
    if virt < cap:                # tail virtuals, in order
        perm[virt:cap] = np.arange(slot, cap)
    return perm if capacity is not None else perm[:n]


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

class PlacementPolicy:
    """Observe transcripts, propose placed :class:`GridPlan`\\ s.

    Mirrors ``core/adaptive.py``'s ``GroupSizeController`` contract:
    :meth:`observe` consumes each iteration's transcript and returns a
    full proposed plan (same dims, new ``placement``) or ``None``;
    ``Federation.regroup`` / ``launch/train.py`` apply proposals as
    membership-preserving regroups. :meth:`rebind` re-anchors the
    policy after an adaptive-M dims change or elastic resize — the
    policy re-emits its permutation for the new plan on the next
    observe. :meth:`bind_prober` hands policies that need active
    measurement (``clustered``) a ``MessagePlan -> Transcript``
    callable bound to the live transport.
    """

    name: str = "?"

    def __init__(self, plan: GridPlan, seed: int = 0):
        self.plan = plan
        self.seed = seed
        self._prober: Optional[Callable[[MessagePlan], Any]] = None

    def bind_prober(self, prober: Callable[[MessagePlan], Any]) -> None:
        self._prober = prober

    def observe(self, t: int, transcript: Any,
                plan: GridPlan) -> Optional[GridPlan]:
        raise NotImplementedError

    def rebind(self, plan: GridPlan) -> None:
        self.plan = plan


@register_placement
class IdentityPlacement(PlacementPolicy):
    """Raw-index coordinates — today's behavior, and the baseline every
    benchmark compares against. Clears any stray placement."""

    name = "identity"

    def observe(self, t, transcript, plan):
        self.plan = plan
        if plan.placement is not None:
            return plan.with_placement(None)
        return None


@register_placement
class RandomPlacement(PlacementPolicy):
    """One seeded random permutation, held fixed — the control arm
    that shows *where* peers sit matters, not just that they moved."""

    name = "random"

    def _perm(self, n: int) -> np.ndarray:
        return np.random.default_rng(self.seed * 60013 + 29) \
            .permutation(n)

    def observe(self, t, transcript, plan):
        self.plan = plan
        target = plan.with_placement(self._perm(plan.n_peers))
        return target if target != plan else None


@register_placement
class ClusteredPlacement(PlacementPolicy):
    """Learn network regions from link evidence; pack each into
    contiguous grid slots.

    Every ``interval`` iterations the policy turns its accumulated
    :class:`LinkQualityEstimator` evidence into a [n_peers, landmarks]
    seconds-per-byte matrix. MAR transcripts only cover each peer's
    grid partners, so when landmark coverage is below ``min_coverage``
    the policy sends :func:`probe_plan` through the bound prober
    instead (the designed fallback: transcript evidence first,
    ``LinkModel``-timed probe rounds when that is too sparse). Peers
    are k-means-clustered on log10 cost rows (log because bandwidths
    span decades; pairwise WAN terms separate same-tier regions that
    per-peer parameters cannot), and :func:`cluster_permutation` packs
    clusters contiguously — for cluster counts ≤ dims[0] all
    cross-cluster traffic lands in the round-0 axis alone.

    Proposals are stable: identical evidence reproduces identical
    labels, and a permutation equal to the live plan's proposes
    nothing. After a dims change (:meth:`rebind`) cached labels re-emit
    the permutation for the new grid without re-probing.
    """

    name = "clustered"

    def __init__(self, plan: GridPlan, seed: int = 0,
                 interval: int = 8, k: Optional[int] = None,
                 landmarks: int = 8, probe_bytes: float = 250_000.0,
                 min_coverage: float = 0.9,
                 drift_threshold: float = 0.5,
                 drift_min_interval: int = 2):
        super().__init__(plan, seed)
        self.interval = interval
        self.k = k
        self.n_landmarks = landmarks
        self.probe_bytes = probe_bytes
        self.min_coverage = min_coverage
        self.drift_threshold = drift_threshold
        self.drift_min_interval = drift_min_interval
        self.estimator = LinkQualityEstimator(plan.n_peers)
        self.labels: Optional[np.ndarray] = None
        self._last_cluster_t: Optional[int] = None

    # -- evidence → labels ----------------------------------------------
    def _landmarks(self, n: int) -> np.ndarray:
        l = min(self.n_landmarks, n)
        return np.unique(np.linspace(0, n - 1, l).round()
                         .astype(np.int64))

    def _features(self, cost: np.ndarray,
                  landmarks: np.ndarray) -> np.ndarray:
        """log10 cost rows. A landmark's own entry (no self-link) is
        imputed with the column minimum — a landmark is maximally
        close to itself, and the median would drag it toward whichever
        region holds the most peers; other gaps take the column
        median."""
        X = np.log10(cost)
        lm = np.asarray(landmarks)
        for j in range(X.shape[1]):
            col = X[:, j]
            finite = col[np.isfinite(col)]
            if finite.size:
                col[~np.isfinite(col)] = float(np.median(finite))
                X[lm[j], j] = float(finite.min())
            else:
                col[~np.isfinite(col)] = 0.0
        return X

    def _recluster(self, n: int) -> Optional[np.ndarray]:
        lm = self._landmarks(n)
        if self.estimator.coverage(lm) < self.min_coverage:
            if self._prober is None:
                return None
            tr = self._prober(probe_plan(n, lm, self.probe_bytes))
            self.estimator.update(tr)
            if self.estimator.coverage(lm) < self.min_coverage:
                return None
        X = self._features(self.estimator.cost_to(lm), lm)
        return cluster_labels(X, k=self.k, seed=self.seed)

    # -- policy surface -------------------------------------------------
    def observe(self, t, transcript, plan):
        self.plan = plan
        n = plan.n_peers
        if transcript is not None:
            self.estimator.update(transcript)
        since = (None if self._last_cluster_t is None
                 else t - self._last_cluster_t)
        due = since is None or since >= self.interval
        if not due and since >= self.drift_min_interval \
                and self.estimator.drift() > self.drift_threshold:
            # link quality moved enough that the current permutation
            # reflects a stale network — re-cluster ahead of cadence,
            # but never faster than drift_min_interval (the same
            # rate-limit contract the probe path honors)
            due = True
        if due:
            labels = self._recluster(n)
            if labels is not None:
                self.labels = labels
                self._last_cluster_t = t
                self.estimator.mark()
        if self.labels is None or self.labels.size != n:
            return None
        target = plan.with_placement(cluster_permutation(
            self.labels, capacity=plan.capacity,
            align=(plan.capacity // plan.dims[0]
                   if plan.depth else None)))
        return target if target != plan else None

    def rebind(self, plan):
        if plan.n_peers != self.plan.n_peers:
            self.estimator.resize(plan.n_peers)
            self.labels = None
            self._last_cluster_t = None     # re-probe promptly
        self.plan = plan
