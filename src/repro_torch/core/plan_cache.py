"""Content-addressed plan cache: solve each (graph, budget, family,
objective) once, ever.

The DP of Algorithm 1 is exponential in the worst case (§4.2), yet the
framework re-plans constantly: every ``Planner.plan`` call, every budget
point of a trade-off sweep (benchmarks/fig3_tradeoff.py), every cell of the
dry-run matrix, and every restart of a training job re-solve graphs that
were already solved.  This module memoizes solved ``DPResult``s behind a
canonical content address so repeated planning is a hash lookup:

* **two entry kinds** — ``plan`` entries keyed by ``(graph_digest, budget,
  family, objective)`` hold one ``DPResult``; ``sweep`` entries keyed by
  ``(graph_digest, family, objective)`` — **no budget** — hold the whole
  budget-free frontier of ``core.dp.sweep``, so a single cold solve admits
  every future budget query (per-budget plans, minimal-feasible-budget
  probes, trade-off grids) on that graph.  ``graph_digest`` (core.graph) is
  invariant under node-id permutation and covers topology + quantized
  costs + kinds.  Calibrated costs from the measured cost model
  (core.cost_model) flow into the digest automatically, so re-profiling on
  different hardware *invalidates* stale plans by construction — no epoch
  counters needed; sharded planning flows in the same way (per-device
  ``M_v`` is part of the digest), and the DP's memory-functional version
  (``dp.MEMORY_FUNCTIONAL``) is hashed into every key, so plans solved
  under an older functional (e.g. the pre-liveness eq. 2) can never be
  served.  docs/plan_cache.md spells out the full invalidation matrix.
* **values in canonical coordinates** — lower-set sequences are stored as
  canonical node positions and mapped back through the querying graph's
  canonical order, so a cached plan transfers between isomorphic labelings
  (e.g. the same network traced twice with different eqn numbering).
* **three tiers** — an in-memory LRU (per process) over an optional on-disk
  content-addressed store (crash-safe single-file JSON writes; filename =
  SHA-256 of the key, sharded by 2-hex-char prefix like a git object
  store), over an optional **fleet-shared remote store** (``RemoteStore``)
  in read-through mode: a miss in the local tiers fetches from the remote
  and back-fills memory + disk, and every put pushes through, so a plan
  solved by any process in the fleet is a lookup for every other one.
  Content addressing makes read-through trivially coherent — two stores
  can only ever hold the *same* bytes under a hash, so there is no
  staleness protocol; the invalidation matrix is unchanged.  Concurrent
  writers on one digest are serialized by an O_EXCL ``.lock`` file
  (``_locked_write_json``); a loser skips the write (same bytes anyway).
* **validated hits** — every hit is re-validated against the querying graph
  (``check_increasing_sequence``), so a digest collision or a corrupt cache
  file degrades to a miss, never a wrong plan.

Process-wide default: ``default_cache()`` (used by ``core.planner.Planner``
when no cache is passed); ``set_default_cache_dir`` attaches the disk tier —
the train loop and serving engine call it when configured with a
``plan_cache_dir``, so co-located jobs share one store.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.checkpointing.store import atomic_write_json, read_json

from .dp import MEMORY_FUNCTIONAL, DPResult, Sweep, decode_sweep
from .graph import Graph, NodeSet, canonical_maps, graph_digest

# Bump whenever the stored shape changes; v2 = liveness-tight memory
# functional (peaks/feasibility of stored plans and sweeps are priced by
# dp.MEMORY_FUNCTIONAL, which is also hashed into every key, so entries
# solved under eq. 2 — or any future functional — invalidate by
# construction, exactly like a cost-model recalibration does through the
# graph digest).
FORMAT_VERSION = 2

#: a ``.lock`` older than this is presumed abandoned (holder crashed between
#: acquiring and unlinking) and is broken by the next writer
STALE_LOCK_SECONDS = 60.0


def _locked_write_json(path: str, obj: object,
                       stale_s: float = STALE_LOCK_SECONDS) -> bool:
    """Cross-process exclusive JSON write; returns True when this call wrote.

    ``atomic_write_json`` alone is torn-read-safe (temp file + rename) but
    two processes read-through-solving the same digest would both write.
    An ``O_CREAT | O_EXCL`` sidecar ``<path>.lock`` serializes them; the
    loser simply *skips* — entries are content-addressed, so the winner is
    writing byte-identical data and a second write is pure waste.  A lock
    older than ``stale_s`` is presumed leaked by a crashed holder and is
    broken (unlink + retry once).
    """
    lock = path + ".lock"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        try:
            age = time.time() - os.path.getmtime(lock)
        except OSError:
            return False  # holder finished between our open and stat
        if age < stale_s:
            return False  # live writer owns this digest; same bytes anyway
        try:
            os.unlink(lock)  # break the stale lock …
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except OSError:
            return False  # … lost the re-acquire race — fine, skip
    try:
        atomic_write_json(path, obj)
        return True
    finally:
        os.close(fd)
        try:
            os.unlink(lock)
        except OSError:  # pragma: no cover — lock vanished under us
            pass


def _locked_unlink(path: str, stale_s: float = STALE_LOCK_SECONDS) -> bool:
    """Cross-process exclusive delete; returns True when this call removed.

    The GC sweep's counterpart of :func:`_locked_write_json`: deleting an
    entry takes the same ``<path>.lock`` sidecar, so a sweep never yanks a
    file out from under an in-flight write (the writer holds the lock for
    the whole temp-file + rename).  A held live lock means someone is
    *refreshing* this digest — skip it, it is not garbage.  Stale locks are
    broken with the same age rule as writes.
    """
    lock = path + ".lock"
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        try:
            age = time.time() - os.path.getmtime(lock)
        except OSError:
            return False  # holder finished between our open and stat
        if age < stale_s:
            return False  # live writer — the entry is being refreshed
        try:
            os.unlink(lock)
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except OSError:
            return False
    except OSError:
        return False  # e.g. shard directory already swept away
    try:
        os.unlink(path)
        return True
    except OSError:
        return False
    finally:
        os.close(fd)
        try:
            os.unlink(lock)
        except OSError:  # pragma: no cover — lock vanished under us
            pass


# ---------------------------------------------------------------------------
# Remote (fleet-shared) stores: the third tier under LRU + disk.
# ---------------------------------------------------------------------------


class RemoteStore:
    """Transport interface for a fleet-shared plan store.

    Implementations move opaque ``(content_hash → JSON entry)`` pairs; all
    keying, validation, and coherence live in :class:`PlanCache` — content
    addresses make read-through trivially coherent, so a transport needs no
    consistency guarantees beyond "a fetch returns bytes some push wrote
    (or None)".  Transport failures should raise ``OSError`` (counted as
    ``remote_errors`` and degraded to a miss, never a planning failure).
    """

    scheme = "abstract"

    def fetch(self, content_hash: str) -> Optional[dict]:
        raise NotImplementedError

    def push(self, content_hash: str, entry: dict) -> None:
        raise NotImplementedError


class SharedFSStore(RemoteStore):
    """Shared-filesystem transport (NFS / Lustre / GCS-fuse mount).

    Same sharded object layout as the local disk tier, so a fleet store can
    be seeded by simply copying a warm node's cache directory.  Pushes go
    through :func:`_locked_write_json` — concurrent read-through writers on
    one digest across *hosts* are serialized by the O_EXCL lock.

    **Bounded** when constructed with ``max_bytes`` and/or ``max_age_s``:
    a fleet store accretes one entry per (graph, budget/sweep) signature
    forever — re-profiling, functional bumps and model churn all mint new
    digests and orphan the old ones.  :meth:`gc` sweeps the object tree:
    entries older than ``max_age_s`` go first, then oldest-first until the
    tree fits ``max_bytes``.  Deletions take each entry's O_EXCL ``.lock``
    (``_locked_unlink``), so a sweep never races an in-flight writer, and
    any entry it does remove is merely re-solvable — content addressing
    means eviction can never serve a *wrong* plan, only cost a re-solve.
    Every ``gc_every``-th push triggers an opportunistic sweep so
    long-running pushers keep the store bounded without a cron job.
    """

    scheme = "file"

    def __init__(self, root: str, max_bytes: Optional[int] = None,
                 max_age_s: Optional[float] = None, gc_every: int = 64):
        self.root = root
        self.max_bytes = max_bytes
        self.max_age_s = max_age_s
        self.gc_every = max(int(gc_every), 1)
        self._pushes = 0

    def _path(self, content_hash: str) -> str:
        return os.path.join(
            self.root, "plans", content_hash[:2], content_hash + ".json"
        )

    def fetch(self, content_hash: str) -> Optional[dict]:
        entry = read_json(self._path(content_hash))
        return entry if isinstance(entry, dict) else None

    def push(self, content_hash: str, entry: dict) -> None:
        _locked_write_json(self._path(content_hash), entry)
        self._pushes += 1
        if (self.max_bytes is not None or self.max_age_s is not None) \
                and self._pushes % self.gc_every == 0:
            self.gc()

    def _scan(self) -> List[Tuple[float, int, str]]:
        """All entry files as ``(mtime, size, path)``, oldest first."""
        out: List[Tuple[float, int, str]] = []
        plans = os.path.join(self.root, "plans")
        try:
            shards = sorted(os.scandir(plans), key=lambda d: d.name)
        except OSError:
            return out
        for shard in shards:
            if not shard.is_dir():
                continue
            try:
                files = os.scandir(shard.path)
            except OSError:
                continue
            for f in files:
                if not f.name.endswith(".json"):
                    continue  # .lock sidecars and foreign files
                try:
                    st = f.stat()
                except OSError:
                    continue  # deleted under us by a concurrent sweep
                out.append((st.st_mtime, st.st_size, f.path))
        out.sort()
        return out

    def gc(self, now: Optional[float] = None) -> Dict[str, int]:
        """One sweep; returns ``{scanned, removed, bytes, bytes_freed}``.

        Age rule first (anything older than ``max_age_s``), then the size
        rule (evict oldest-first until the surviving tree is ≤
        ``max_bytes``).  Entries whose lock is held by a live writer are
        skipped — they are being refreshed, not garbage.
        """
        entries = self._scan()
        total = sum(size for _, size, _ in entries)
        scanned = len(entries)
        removed = 0
        freed = 0
        t0 = time.time() if now is None else now
        survivors: List[Tuple[float, int, str]] = []
        for mtime, size, path in entries:
            if self.max_age_s is not None and t0 - mtime > self.max_age_s:
                if _locked_unlink(path):
                    removed += 1
                    freed += size
                    continue
            survivors.append((mtime, size, path))
        if self.max_bytes is not None:
            live = total - freed
            for mtime, size, path in survivors:  # oldest first
                if live <= self.max_bytes:
                    break
                if _locked_unlink(path):
                    removed += 1
                    freed += size
                    live -= size
        return {"scanned": scanned, "removed": removed,
                "bytes": total - freed, "bytes_freed": freed}


class CallableStore(RemoteStore):
    """User-supplied transport as two callables — no subclassing needed.

    ``fetch(content_hash) -> Optional[dict]`` and
    ``push(content_hash, entry: dict) -> None`` over any blob client
    (boto3, google-cloud-storage, an internal KV service…).  The adapter
    normalizes non-dict fetch results to ``None`` (a miss) so a sloppy
    transport can't feed the decoder garbage; transport exceptions follow
    the :class:`RemoteStore` contract (raise ``OSError`` to be counted and
    degraded to a miss).
    """

    def __init__(
        self,
        fetch: Callable[[str], Optional[dict]],
        push: Callable[[str, dict], None],
        scheme: str = "callable",
    ):
        self._fetch = fetch
        self._push = push
        self.scheme = scheme

    def fetch(self, content_hash: str) -> Optional[dict]:
        entry = self._fetch(content_hash)
        return entry if isinstance(entry, dict) else None

    def push(self, content_hash: str, entry: dict) -> None:
        self._push(content_hash, entry)


class _ObjectStoreStub(RemoteStore):
    """Placeholder for unregistered bucket transports (s3:// / gs://):
    constructing one names the URL it would serve; using it raises with a
    pointer to :func:`register_transport`.  Kept importable so launcher
    configs can carry bucket URLs before the blob client is wired up."""

    def __init__(self, scheme: str, url: str):
        self.scheme = scheme
        self.url = url

    def _unimplemented(self) -> "NotImplementedError":
        return NotImplementedError(
            f"no transport registered for {self.scheme}:// plan stores: "
            f"register_transport({self.scheme!r}, factory) with a factory "
            f"returning a RemoteStore/CallableStore over your object-store "
            f"client (url: {self.url!r})"
        )

    def fetch(self, content_hash: str) -> Optional[dict]:
        raise self._unimplemented()

    def push(self, content_hash: str, entry: dict) -> None:
        raise self._unimplemented()


#: URL-scheme → factory taking the full URL and returning the transport.
_TRANSPORTS: Dict[str, Callable[[str], RemoteStore]] = {}


def register_transport(
    scheme: str, factory: Callable[[str], RemoteStore]
) -> None:
    """Register (or replace) the transport factory for a URL scheme.

    Lets deployments route ``s3://`` / ``gs://`` (or any custom scheme) plan
    stores through their own client without forking this module::

        register_transport("s3", lambda url: CallableStore(
            fetch=lambda h: my_get_json(url, h),
            push=lambda h, e: my_put_json(url, h, e),
            scheme="s3"))

    Every URL-configured entry point then resolves through it —
    ``PlanCache(remote="s3://bucket/plans")``, ``set_default_remote_store``,
    the ``REPRO_PLAN_REMOTE_DIR`` env var, the serving engine's
    ``plan_remote=``.  Registering ``"file"`` overrides the built-in
    :class:`SharedFSStore` resolution (e.g. to attach GC bounds).
    """
    _TRANSPORTS[scheme] = factory


def remote_store_from_url(url: str) -> RemoteStore:
    """``/dir``, ``file:///dir`` → :class:`SharedFSStore`; a registered
    scheme (``register_transport``) → its factory; unregistered ``s3://`` /
    ``gs://`` → the object-store stub (raises on first use)."""
    if "://" not in url:
        return SharedFSStore(url)
    scheme, _, rest = url.partition("://")
    if scheme in _TRANSPORTS:
        return _TRANSPORTS[scheme](url)
    if scheme == "file":
        return SharedFSStore("/" + rest.lstrip("/") if rest else "/")
    if scheme in ("s3", "gs"):
        return _ObjectStoreStub(scheme, url)
    raise ValueError(f"unknown plan-store scheme {scheme!r} in {url!r}")


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Identity of one planning problem.

    ``family`` names the lower-set family ("exact_dp" / "approx_dp" /
    "segment" / a digest of a custom family); ``budget`` is kept in full
    float precision via ``repr`` so distinct budgets never alias.
    """

    graph_digest: str
    budget: float
    family: str
    objective: str
    #: Strategy-lattice token (``StrategyConfig.digest_token()``): the
    #: enabled strategy set + bandwidths.  Empty for the paper's binary —
    #: and *omitted* from the payload then, so every pre-lattice digest is
    #: byte-identical to what it always was.
    strategy: str = ""

    def content_hash(self) -> str:
        parts = [
            f"v{FORMAT_VERSION}",
            MEMORY_FUNCTIONAL,
            self.graph_digest,
            repr(float(self.budget)),
            self.family,
            self.objective,
        ]
        if self.strategy:
            parts.append(self.strategy)
        return hashlib.sha256("|".join(parts).encode()).hexdigest()


@dataclasses.dataclass(frozen=True)
class SweepKey:
    """Identity of one budget-*free* planning problem (``core.dp.sweep``).

    Deliberately has no budget: one cached sweep answers every budget query
    on its ``(graph, family, objective)`` by frontier lookup, which is what
    turns the §5.1 binary search and multi-budget trade-off grids into
    cache hits after a single cold solve.
    """

    graph_digest: str
    family: str
    objective: str
    strategy: str = ""  # StrategyConfig.digest_token(); "" keeps legacy bytes

    def content_hash(self) -> str:
        parts = [f"sweep-v{FORMAT_VERSION}", MEMORY_FUNCTIONAL,
                 self.graph_digest, self.family, self.objective]
        if self.strategy:
            parts.append(self.strategy)
        return hashlib.sha256("|".join(parts).encode()).hexdigest()


def _to_canonical(seq: Sequence[NodeSet], to_pos: Dict[int, int]) -> List[List[int]]:
    return [sorted(to_pos[v] for v in L) for L in seq]


def _from_canonical(seq: List[List[int]], from_pos: List[int]) -> List[NodeSet]:
    return [frozenset(from_pos[p] for p in L) for L in seq]


class PlanCache:
    """In-memory LRU over an optional on-disk content-addressed store, over
    an optional fleet-shared :class:`RemoteStore` (read-through + push-
    through).  ``last_tier`` records which tier served the most recent hit
    (``"memory"`` / ``"disk"`` / ``"remote"``; ``None`` after a miss) — the
    user-visible provenance ``examples/plan_explorer.py`` prints."""

    def __init__(self, capacity: int = 512, cache_dir: Optional[str] = None,
                 remote: Optional[Union[RemoteStore, str]] = None):
        self.capacity = capacity
        self.cache_dir = cache_dir
        self.remote = (
            remote_store_from_url(remote) if isinstance(remote, str) else remote
        )
        self._mem: "OrderedDict[str, dict]" = OrderedDict()
        # Decoded-plan LRU: repeat hits skip JSON decode + re-validation
        # (rebuilding a 100k-element lower-set sequence costs ~10 ms on the
        # big nets — too slow for a serving hot path).  Keyed by the entry
        # hash AND the querying graph's relabeling (canonical order), so
        # isomorphic graphs with different node ids never share a decode.
        self._decoded: "OrderedDict[Tuple[str, Tuple[int, ...]], DPResult]" = (
            OrderedDict()
        )
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0
        self.remote_hits = 0
        self.invalid_hits = 0  # validation failures (collision/corruption)
        self.disk_errors = 0  # unusable store (permissions, bad path, ENOSPC)
        self.remote_errors = 0  # unusable transport (degrades to a miss)
        self.last_tier: Optional[str] = None

    # ------------------------------------------------------------------ keys

    @staticmethod
    def key_for(
        g: Graph, budget: float, family: str, objective: str,
        strategy: str = "",
    ) -> PlanKey:
        return PlanKey(
            graph_digest(g), float(budget), family, objective, strategy
        )

    # ------------------------------------------------------------------ disk

    def _path(self, content_hash: str) -> Optional[str]:
        if not self.cache_dir:
            return None
        return os.path.join(
            self.cache_dir, "plans", content_hash[:2], content_hash + ".json"
        )

    def _disk_write(self, content_hash: str, entry: dict) -> None:
        """Best-effort disk write: an unusable store (read-only mount, path
        collision, ENOSPC) must degrade the cache to memory-only, never take
        the planning job down.  Locked (O_EXCL sidecar): the disk tier may be
        a directory shared by co-located processes racing the same digest —
        the loser skips, since content addressing makes both writes
        byte-identical anyway."""
        path = self._path(content_hash)
        if path is None:
            return
        try:
            _locked_write_json(path, entry)
        except OSError:
            self.disk_errors += 1

    # ----------------------------------------------------------------- remote

    def _remote_fetch(self, content_hash: str) -> Optional[dict]:
        """Read-through fetch; transport failures degrade to a miss."""
        if self.remote is None:
            return None
        try:
            entry = self.remote.fetch(content_hash)
        except (OSError, NotImplementedError):
            self.remote_errors += 1
            return None
        return entry if isinstance(entry, dict) else None

    def _remote_push(self, content_hash: str, entry: dict) -> None:
        """Best-effort push-through — a broken transport never fails a put."""
        if self.remote is None:
            return
        try:
            self.remote.push(content_hash, entry)
        except (OSError, NotImplementedError):
            self.remote_errors += 1

    def _lookup(self, content_hash: str) -> Tuple[Optional[dict], str]:
        """memory → disk → remote; returns ``(entry, tier)`` (entry None on
        a full miss).  Tier *accounting* and local back-fill happen in the
        callers, after the entry validates against the querying graph."""
        entry = self._mem_get(content_hash)
        if entry is not None:
            return entry, "memory"
        path = self._path(content_hash)
        if path is not None:
            entry = read_json(path)
            if entry is not None:
                return entry, "disk"
        entry = self._remote_fetch(content_hash)
        if entry is not None:
            return entry, "remote"
        return None, "miss"

    def _record_hit(self, content_hash: str, entry: dict, tier: str) -> None:
        """Validated hit: count it, back-fill the faster tiers, stamp
        ``last_tier``."""
        if tier == "disk":
            self.disk_hits += 1
            self._mem_put(content_hash, entry)
        elif tier == "remote":
            self.remote_hits += 1
            self._mem_put(content_hash, entry)
            self._disk_write(content_hash, entry)
        self.hits += 1
        self.last_tier = tier

    # ------------------------------------------------------------------- LRU

    def _mem_get(self, h: str) -> Optional[dict]:
        with self._lock:
            entry = self._mem.get(h)
            if entry is not None:
                self._mem.move_to_end(h)
            return entry

    def _mem_put(self, h: str, entry: dict) -> None:
        with self._lock:
            self._mem[h] = entry
            self._mem.move_to_end(h)
            while len(self._mem) > self.capacity:
                self._mem.popitem(last=False)

    # ------------------------------------------------------------------- API

    def _decoded_get(self, dk: "Tuple[str, Tuple[int, ...]]") -> Optional[DPResult]:
        with self._lock:
            res = self._decoded.get(dk)
            if res is not None:
                self._decoded.move_to_end(dk)
        if res is None:
            return None
        # fresh sequence list / assignment dict: callers may mutate them
        return dataclasses.replace(
            res, sequence=list(res.sequence),
            assignment=dict(res.assignment) if res.assignment is not None else None,
        )

    def _decoded_put(self, dk: "Tuple[str, Tuple[int, ...]]", res: DPResult) -> None:
        with self._lock:
            self._decoded[dk] = dataclasses.replace(
                res, sequence=list(res.sequence)
            )
            self._decoded.move_to_end(dk)
            while len(self._decoded) > self.capacity:
                self._decoded.popitem(last=False)

    def get(self, g: Graph, key: PlanKey) -> Optional[DPResult]:
        """Cached DPResult for ``key``, re-labeled onto ``g``; None on miss.

        Hits are validated against ``g`` (increasing lower-set sequence); an
        entry that fails validation is treated as a miss and evicted.
        Repeat hits for the same relabeling are served from the decoded LRU
        at memory-lookup latency (they validated when first decoded).
        """
        h = key.content_hash()
        _, from_pos = canonical_maps(g)
        dk = (h, tuple(from_pos))
        cached = self._decoded_get(dk)
        if cached is not None:
            self.hits += 1
            self.last_tier = "memory"
            return cached
        entry, tier = self._lookup(h)
        if entry is None:
            self.misses += 1
            self.last_tier = None
            return None

        result = self._decode(g, entry)
        if result is None:
            self.invalid_hits += 1
            self.misses += 1
            self.last_tier = None
            with self._lock:
                self._mem.pop(h, None)
            return None
        self._record_hit(h, entry, tier)
        self._decoded_put(dk, result)
        return result

    def put(self, g: Graph, key: PlanKey, result: DPResult) -> None:
        to_pos, _ = canonical_maps(g)
        entry = {
            "version": FORMAT_VERSION,
            "key": dataclasses.asdict(key),
            "feasible": bool(result.feasible),
            "sequence": _to_canonical(result.sequence, to_pos),
            "overhead": result.overhead,
            "peak_memory": result.peak_memory,
            "states_visited": int(result.states_visited),
        }
        if result.assignment is not None:
            # canonical node positions, like the sequence; the field is
            # omitted for binary plans, keeping legacy entries byte-identical
            entry["assignment"] = {
                str(to_pos[v]): code for v, code in result.assignment.items()
            }
        h = key.content_hash()
        self._mem_put(h, entry)
        self._decoded_put((h, tuple(canonical_maps(g)[1])), result)
        self._disk_write(h, entry)
        self._remote_push(h, entry)

    def _decode(self, g: Graph, entry: dict) -> Optional[DPResult]:
        try:
            # a foreign/corrupt store file can be any JSON value, not a dict
            if not isinstance(entry, dict) or entry.get("version") != FORMAT_VERSION:
                return None
            if not entry["feasible"]:
                return DPResult(
                    sequence=[],
                    overhead=float("inf"),
                    peak_memory=float("inf"),
                    feasible=False,
                    states_visited=int(entry.get("states_visited", 0)),
                )
            _, from_pos = canonical_maps(g)
            seq = _from_canonical(entry["sequence"], from_pos)
            g.check_increasing_sequence(seq)
            assignment = None
            if "assignment" in entry:
                assignment = {
                    from_pos[int(p)]: str(code)
                    for p, code in entry["assignment"].items()
                }
            return DPResult(
                sequence=seq,
                overhead=float(entry["overhead"]),
                peak_memory=float(entry["peak_memory"]),
                feasible=True,
                states_visited=int(entry.get("states_visited", 0)),
                assignment=assignment,
            )
        except (KeyError, IndexError, TypeError, ValueError):
            return None

    # ------------------------------------------------------------- sweeps

    @staticmethod
    def sweep_key_for(
        g: Graph, family: str, objective: str, strategy: str = ""
    ) -> SweepKey:
        return SweepKey(graph_digest(g), family, objective, strategy)

    def get_sweep(self, key: SweepKey, count_miss: bool = True) -> Optional[Sweep]:
        """Cached sweep in **canonical coordinates**; None on miss.

        Unlike plan entries there is no per-get structural validation
        against a querying graph — a sweep is not a single plan but a whole
        surface.  Callers (``core.planner.Planner``) validate each
        *extracted* sequence instead, so corruption still degrades to a
        miss at the point of use, never a wrong plan.

        ``count_miss=False`` keeps an absent sweep out of the miss stats —
        for opportunistic probes whose fallback lookup (a ``plan`` entry)
        does its own accounting.
        """
        h = key.content_hash()
        entry, tier = self._lookup(h)
        if entry is None:
            if count_miss:
                self.misses += 1
                self.last_tier = None
            return None
        sweep = None
        if isinstance(entry, dict) and entry.get("version") == FORMAT_VERSION \
                and entry.get("kind") == "sweep":
            sweep = decode_sweep(entry)
        if sweep is None:
            self.invalid_hits += 1
            self.misses += 1
            self.last_tier = None
            with self._lock:
                self._mem.pop(h, None)
            return None
        self._record_hit(h, entry, tier)
        return sweep

    def put_sweep(self, key: SweepKey, sweep: Sweep) -> None:
        """Store a sweep (caller must pass it in canonical coordinates)."""
        entry = {"version": FORMAT_VERSION, "kind": "sweep",
                 "key": dataclasses.asdict(key), **sweep.encode()}
        h = key.content_hash()
        self._mem_put(h, entry)
        self._disk_write(h, entry)
        self._remote_push(h, entry)

    # ------------------------------------------------- auxiliary scalar store

    def get_aux(self, namespace: str, key: str) -> Optional[float]:
        """Small keyed scalar store (e.g. min-feasible-budget results)."""
        h = hashlib.sha256(f"aux|{namespace}|{key}".encode()).hexdigest()
        entry, tier = self._lookup(h)
        if not isinstance(entry, dict) or "value" not in entry:
            return None
        if entry.get("version") != FORMAT_VERSION:
            return None  # e.g. a min-budget computed under an old functional
        try:
            value = float(entry["value"])
        except (TypeError, ValueError):
            return None
        if tier != "memory":
            self._mem_put(h, entry)
            if tier == "remote":
                self._disk_write(h, entry)
        return value

    def put_aux(self, namespace: str, key: str, value: float) -> None:
        h = hashlib.sha256(f"aux|{namespace}|{key}".encode()).hexdigest()
        entry = {"version": FORMAT_VERSION, "value": float(value)}
        self._mem_put(h, entry)
        self._disk_write(h, entry)
        self._remote_push(h, entry)

    # ----------------------------------------------------------------- stats

    def stats(self) -> Dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "disk_hits": self.disk_hits,
            "remote_hits": self.remote_hits,
            "invalid_hits": self.invalid_hits,
            "disk_errors": self.disk_errors,
            "remote_errors": self.remote_errors,
            "entries_in_memory": len(self._mem),
        }

    def clear_memory(self) -> None:
        with self._lock:
            self._mem.clear()
            self._decoded.clear()


# ---------------------------------------------------------------------------
# Process-wide default cache (planner front door).
# ---------------------------------------------------------------------------

_DEFAULT = PlanCache()


def default_cache() -> PlanCache:
    return _DEFAULT


def set_default_cache_dir(path: Optional[str]) -> PlanCache:
    """Attach (or detach, with None) the disk tier of the default cache.

    Called by the train loop / serving engine when configured with a
    ``plan_cache_dir``; also respects the ``REPRO_PLAN_CACHE_DIR`` env var
    via ``cache_dir_from_env``.

    The store is deliberately **process-global** (co-located jobs share one
    content-addressed store; entries are keyed by content, so sharing is
    always safe).  Repointing an already-attached store to a *different*
    directory is almost certainly a configuration mistake — two components
    were configured with conflicting dirs — so it warns.
    """
    if (
        path is not None
        and _DEFAULT.cache_dir is not None
        and os.path.abspath(path) != os.path.abspath(_DEFAULT.cache_dir)
    ):
        import warnings

        warnings.warn(
            f"plan cache dir repointed {_DEFAULT.cache_dir!r} -> {path!r}; "
            "the store is process-global and shared by every planner",
            stacklevel=2,
        )
    _DEFAULT.cache_dir = path
    return _DEFAULT


def set_default_remote_store(
    store: Optional[Union[RemoteStore, str]]
) -> PlanCache:
    """Attach (or detach, with None) the fleet tier of the default cache.

    Accepts a :class:`RemoteStore` instance or a URL for
    :func:`remote_store_from_url`.  Like the disk tier, the remote is
    process-global: the serving engine, the launchers and ad-hoc planning
    all read through (and push to) the same fleet store.
    """
    _DEFAULT.remote = (
        remote_store_from_url(store) if isinstance(store, str) else store
    )
    return _DEFAULT


def cache_dir_from_env() -> Optional[str]:
    return os.environ.get("REPRO_PLAN_CACHE_DIR") or None


def remote_from_env() -> Optional[str]:
    return os.environ.get("REPRO_PLAN_REMOTE_DIR") or None


# Pick up the env vars at import so every entry point (benchmarks, examples,
# launchers) shares the store without plumbing.
if cache_dir_from_env():
    set_default_cache_dir(cache_dir_from_env())
if remote_from_env():
    set_default_remote_store(remote_from_env())
