"""Placement cache keyed on quantized environment parameters.

The adaptive loop (paper Fig. 1) re-partitions whenever the environment
drifts, but at serving scale the *same* environments recur constantly:
millions of users cycle through a handful of bandwidth/RTT/energy regimes
(WiFi, LTE, congested cell, …).  Re-running MCOP for every request wastes
the work — a placement computed at B = 8.0 MB/s is equally valid at
B = 8.2 MB/s, because the controller's own drift threshold already treats
those as "the same environment".

So the cache key is the environment *quantized* into geometric bins whose
relative width (default 10%) mirrors the drift threshold: two environments
land in the same bin exactly when re-partitioning between them would be
hysteresis noise.  The cached value is the placement *mask only* — on a
hit the caller re-prices the mask under the exact current WCG
(``g.total_cost(mask)``), so reported costs stay honest even when the
placement is reused (same contract as the controller's stale-placement
accounting).

Hit/miss counters make cache effectiveness observable; capacity is
bounded with LRU eviction so a long-lived server can't grow without
limit.  One cache instance should serve one (profile, cost-model)
pair — share it across controllers only when they partition the same
application (that is the multi-user win: N users, one profile, a handful
of environment bins).  At serving scale that sharing is done by the
:class:`repro_torch.service.broker.OffloadBroker`, which owns one cache per
tenant and keeps it warm across process restarts via
:meth:`PlacementCache.snapshot` / :meth:`PlacementCache.load` — a JSON
document guarded by a schema version, the quantizer step, and a
:func:`profile_fingerprint` of the application profile, so a stale or
foreign snapshot degrades to a cold cache instead of serving wrong
placements.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import pathlib
import tempfile
from collections import OrderedDict
from typing import Tuple

import numpy as np

from repro_torch.core.cost_models import Environment

__all__ = [
    "EnvQuantizer",
    "PlacementCache",
    "CacheStats",
    "profile_fingerprint",
    "SNAPSHOT_VERSION",
]

# Bump when the snapshot schema changes; load() ignores unknown versions.
SNAPSHOT_VERSION = 1


def profile_fingerprint(obj) -> str:
    """Stable content hash of an application profile (or WCG).

    Identifies *what was partitioned* so a persisted cache is only warm
    for the same application: masks are meaningless across profiles even
    when the vertex counts happen to match.  Accepts an
    :class:`~repro_torch.core.cost_models.AppProfile` (``t_local``/``data_in``/
    ``data_out``/``offloadable``) or a :class:`~repro_torch.core.graph.WCG`
    (``w_local``/``w_cloud``/``adj``/``offloadable``).
    """
    if hasattr(obj, "t_local"):
        arrays = (obj.t_local, obj.data_in, obj.data_out, obj.offloadable)
    elif hasattr(obj, "w_local"):
        arrays = (obj.w_local, obj.w_cloud, obj.adj, obj.offloadable)
    else:
        raise TypeError(f"cannot fingerprint {type(obj).__name__}")
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class EnvQuantizer:
    """Maps an :class:`Environment` to a hashable bin key.

    Positive scalars are binned geometrically: ``bin(x) = round(ln x / ln
    (1 + rel_step))``, so bins are uniformly ``rel_step`` wide in relative
    terms at every scale — the natural metric for bandwidth/speedup, which
    the drift detector also compares relatively.  Powers enter the key too
    (the energy model prices transfers with them), with the same binning.
    """

    rel_step: float = 0.10

    def bins_batch(self, x: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`bin`: geometric binning of an array of scalars.

        The scalar :meth:`bin` rides this exact code path (a batch of
        one), so batched session engines and per-environment callers can
        never disagree about a bin boundary — ``np.round`` applies the
        same round-half-even rule as Python's ``round``.
        """
        x = np.asarray(x, dtype=np.float64)
        safe = np.where(x > 0.0, x, 1.0)
        b = np.round(np.log(safe) / np.log1p(self.rel_step)).astype(np.int64)
        # non-positive values: degenerate env; one shared sentinel bin
        return np.where(x > 0.0, b, np.int64(-(2**31)))

    def bin(self, x: float) -> int:
        return int(self.bins_batch(np.float64(x)))

    def key(self, env: Environment) -> Tuple[int, ...]:
        return (
            self.bin(env.bandwidth_up),
            self.bin(env.bandwidth_down),
            self.bin(env.speedup),
            self.bin(env.p_compute),
            self.bin(env.p_idle),
            self.bin(env.p_transfer),
        )

    def keys_batch(self, envs) -> np.ndarray:
        """K environments (:class:`~repro_torch.core.cost_models.EnvArrays`) →
        ``(k, 6)`` int64 key rows, column order matching :meth:`key`.

        ``tuple(int(v) for v in row)`` of row ``i`` equals
        ``self.key(envs.env(i))`` exactly — the vectorized front door the
        batched session tick probes the cache with.
        """
        return np.stack(
            [
                self.bins_batch(envs.bandwidth_up),
                self.bins_batch(envs.bandwidth_down),
                self.bins_batch(envs.speedup),
                self.bins_batch(envs.p_compute),
                self.bins_batch(envs.p_idle),
                self.bins_batch(envs.p_transfer),
            ],
            axis=-1,
        )


@dataclasses.dataclass(frozen=True)
class CacheStats:
    hits: int
    misses: int
    size: int
    capacity: int
    evictions: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


class PlacementCache:
    """Quantized-environment → placement-mask cache with LRU eviction.

    ``get``/``put`` are the simple front door.  The batched sweep needs to
    separate *lookup* from *accounting* (a miss early in a sweep becomes a
    hit for later same-bin steps once the batch solve lands), so
    :meth:`lookup` and :meth:`record` are also public.
    """

    def __init__(
        self,
        quantizer: EnvQuantizer | None = None,
        *,
        capacity: int = 4096,
    ):
        if capacity <= 0:
            raise ValueError("cache capacity must be positive")
        self.quantizer = quantizer or EnvQuantizer()
        self.capacity = capacity
        self._entries: OrderedDict[Tuple[int, ...], np.ndarray] = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        # bound metrics instruments (None until bind_metrics); kept as a
        # flat tuple so the hot funnel pays one attribute read when unbound
        self._metric_instruments = None

    def bind_metrics(self, registry, **labels) -> None:
        """Mirror this cache's counters into a
        :class:`~repro_torch.obs.metrics.MetricsRegistry`.

        ``labels`` identify the cache (the broker binds ``tenant=name``).
        Counters ``cache_hits`` / ``cache_misses`` / ``cache_evictions``
        and gauge ``cache_size`` pick up every event from bind time on;
        historical counts are seeded so the registry view equals
        :attr:`stats` at all times.
        """
        hits = registry.counter("cache_hits", **labels)
        misses = registry.counter("cache_misses", **labels)
        evictions = registry.counter("cache_evictions", **labels)
        size = registry.gauge("cache_size", **labels)
        hits.inc(self._hits)
        misses.inc(self._misses)
        evictions.inc(self._evictions)
        size.set(len(self._entries))
        self._metric_instruments = (hits, misses, evictions, size)

    # -- key/lookup/record primitives ----------------------------------
    def key(self, env: Environment) -> Tuple[int, ...]:
        return self.quantizer.key(env)

    def lookup(
        self, key: Tuple[int, ...], expected_n: int | None = None
    ) -> np.ndarray | None:
        """Return the cached local-mask for ``key`` (no counter update).

        ``expected_n`` guards against a cache (mis)shared across profiles
        of different graph sizes: a wrong-length mask is treated as
        absent, so callers never have to re-validate shapes.
        """
        mask = self._entries.get(key)
        if mask is None:
            return None
        if expected_n is not None and mask.shape != (expected_n,):
            return None
        self._entries.move_to_end(key)
        return mask.copy()

    def record(self, hit: bool) -> None:
        self.record_many(hits=int(hit), misses=1 - int(hit))

    def record_many(self, *, hits: int = 0, misses: int = 0) -> None:
        """THE stat funnel: every hit/miss count — scalar :meth:`record`,
        :meth:`get`, :meth:`get_many`, the batched session tick — lands
        here as one shared increment, so the scalar and batched paths
        cannot drift apart, and bound metrics see every event."""
        self._hits += int(hits)
        self._misses += int(misses)
        m = self._metric_instruments
        if m is not None:
            if hits:
                m[0].inc(hits)
            if misses:
                m[1].inc(misses)

    def store(self, key: Tuple[int, ...], local_mask: np.ndarray) -> None:
        self._entries[key] = np.asarray(local_mask, dtype=bool).copy()
        self._entries.move_to_end(key)
        evicted = 0
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            evicted += 1
        self._evictions += evicted
        m = self._metric_instruments
        if m is not None:
            if evicted:
                m[2].inc(evicted)
            m[3].set(len(self._entries))

    # -- convenience front door ----------------------------------------
    def get(
        self, env: Environment, expected_n: int | None = None
    ) -> np.ndarray | None:
        """Counted lookup by environment.

        Args:
          env:        the exact measured environment; quantized to a bin
                      key by the cache's :class:`EnvQuantizer`.
          expected_n: caller's graph size; a cached mask of any other
                      length is treated as a miss (guards a cache
                      mis-shared across profiles).
        Returns:
          ``(n,)`` bool local-mask *copy*, or ``None`` on miss.  Callers
          must re-price the mask under their exact current WCG
          (``g.total_cost(mask)``) — the honesty contract for every
          reused placement.
        """
        mask = self.lookup(self.key(env), expected_n)
        self.record(mask is not None)
        return mask

    def put(self, env: Environment, local_mask: np.ndarray) -> None:
        """Store ``local_mask`` ((n,) bool, copied) under ``env``'s bin."""
        self.store(self.key(env), local_mask)

    # -- batch front door (array-native session engine) ------------------
    def keys_batch(self, envs) -> list[Tuple[int, ...]]:
        """Quantize K environments (an ``EnvArrays``) to K bin keys.

        One vectorized binning pass; element ``i`` equals
        ``self.key(envs.env(i))`` exactly (see
        :meth:`EnvQuantizer.keys_batch`).
        """
        rows = self.quantizer.keys_batch(envs)
        return [tuple(int(v) for v in row) for row in rows]

    def get_many(
        self, envs, expected_n: int | None = None
    ) -> list[np.ndarray | None]:
        """Counted batch lookup: one quantization pass, K probes in order.

        Equivalent to ``[self.get(envs.env(i), expected_n) for i in
        range(envs.k)]`` — identical returned masks, identical hit/miss
        counters, identical LRU recency order (probes touch entries in
        row order) — with the per-environment Python quantization work
        hoisted into one vectorized pass.
        """
        out: list[np.ndarray | None] = []
        hits = 0
        for key in self.keys_batch(envs):
            mask = self.lookup(key, expected_n)
            hits += mask is not None
            out.append(mask)
        # one shared funnel call for the whole batch (not a record() per
        # key): same totals, and scalar/batched accounting share one
        # code path by construction
        self.record_many(hits=hits, misses=len(out) - hits)
        return out

    def put_many(self, envs, local_masks) -> None:
        """Batch store: row ``i`` of ``local_masks`` under ``envs`` row ``i``.

        Same effect as a scalar :meth:`put` loop in row order (later
        same-bin rows overwrite earlier ones, eviction order included).
        """
        masks = np.asarray(local_masks, dtype=bool)
        keys = self.keys_batch(envs)
        if masks.ndim != 2 or masks.shape[0] != len(keys):
            raise ValueError(
                f"local_masks must be ({len(keys)}, n), got {masks.shape}"
            )
        for key, mask in zip(keys, masks):
            self.store(key, mask)

    # -- observability --------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Tuple[int, ...]) -> bool:
        return key in self._entries

    @property
    def stats(self) -> CacheStats:
        return CacheStats(
            hits=self._hits,
            misses=self._misses,
            size=len(self._entries),
            capacity=self.capacity,
            evictions=self._evictions,
        )

    def clear(self) -> None:
        self._entries.clear()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        m = self._metric_instruments
        if m is not None:
            m[3].set(0)

    # -- persistence -----------------------------------------------------
    def snapshot(
        self,
        *,
        fingerprint: str | None = None,
        meta: dict | None = None,
    ) -> dict:
        """JSON-serializable snapshot of the entries (oldest → newest).

        ``fingerprint`` should be :func:`profile_fingerprint` of the
        profile the masks were computed for; :meth:`load` uses it to
        refuse snapshots taken for a different application.  Counters are
        deliberately not persisted — a warm restart starts fresh stats.

        ``meta`` is an opaque JSON-serializable dict stored alongside the
        entries and returned by :meth:`load_with_meta` — the serving
        plane stamps it with the journal sequence / broker tick the
        snapshot covers so a warm restart knows where replay begins.
        """
        doc = {
            "version": SNAPSHOT_VERSION,
            "fingerprint": fingerprint,
            "rel_step": self.quantizer.rel_step,
            "entries": [
                {"key": [int(x) for x in k], "mask": [int(b) for b in v]}
                for k, v in self._entries.items()
            ],
        }
        if meta is not None:
            doc["meta"] = dict(meta)
        return doc

    def save(
        self,
        path,
        *,
        fingerprint: str | None = None,
        meta: dict | None = None,
    ) -> None:
        """Atomically write the snapshot to ``path``.

        The document is serialized to a temporary file in the same
        directory and ``os.replace``d over the target, so a crash (or a
        concurrent reader) can never observe a truncated snapshot —
        :meth:`load`'s guards then only ever see whole files.
        """
        path = pathlib.Path(path)
        payload = (
            json.dumps(self.snapshot(fingerprint=fingerprint, meta=meta))
            + "\n"
        )
        fd, tmp = tempfile.mkstemp(
            dir=path.parent or ".", prefix=f".{path.name}.", suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def load(
        self,
        source,
        *,
        fingerprint: str | None = None,
        expected_n: int | None = None,
    ) -> int:
        """Warm-start from a snapshot ``dict`` or a JSON file path.

        Forgiving by design — a serving restart must never crash on a
        stale artifact, it just cold-starts: a missing/corrupt file, an
        unknown schema version, a quantizer ``rel_step`` mismatch (bins
        are not comparable) or a profile-fingerprint mismatch loads
        nothing; individually malformed or wrong-length entries are
        skipped.  Entries land through :meth:`store`, so a snapshot
        larger than ``capacity`` is evicted down to capacity keeping the
        newest (last-written) entries.  Returns the number of entries
        loaded.
        """
        loaded, _ = self.load_with_meta(
            source, fingerprint=fingerprint, expected_n=expected_n
        )
        return loaded

    def load_with_meta(
        self,
        source,
        *,
        fingerprint: str | None = None,
        expected_n: int | None = None,
    ) -> tuple[int, dict | None]:
        """:meth:`load`, also returning the snapshot's ``meta`` dict.

        ``meta`` is ``None`` whenever the snapshot was rejected (any of
        the cold-start guards fired) or carried no metadata — the caller
        can distinguish "warm with provenance" from "cold" in one call.
        """
        if isinstance(source, (str, pathlib.Path)):
            try:
                doc = json.loads(pathlib.Path(source).read_text())
            except (OSError, json.JSONDecodeError, UnicodeDecodeError):
                return 0, None
        else:
            doc = source
        if not isinstance(doc, dict) or doc.get("version") != SNAPSHOT_VERSION:
            return 0, None
        if fingerprint is not None and doc.get("fingerprint") != fingerprint:
            return 0, None
        try:
            rel = float(doc.get("rel_step"))
        except (TypeError, ValueError):
            return 0, None
        if not math.isclose(rel, self.quantizer.rel_step, rel_tol=1e-9):
            return 0, None
        entries = doc.get("entries")
        if not isinstance(entries, list):
            return 0, None
        loaded = 0
        for e in entries:
            try:
                key = tuple(int(x) for x in e["key"])
                mask = np.asarray(e["mask"], dtype=bool)
            except (TypeError, ValueError, KeyError):
                continue
            if mask.ndim != 1 or mask.size == 0:
                continue
            if expected_n is not None and mask.shape != (expected_n,):
                continue
            self.store(key, mask)
            loaded += 1
        meta = doc.get("meta")
        return loaded, (dict(meta) if isinstance(meta, dict) else None)

    @classmethod
    def from_snapshot(
        cls,
        source,
        *,
        fingerprint: str | None = None,
        quantizer: EnvQuantizer | None = None,
        capacity: int = 4096,
    ) -> "PlacementCache":
        """Construct and warm-start in one step (serving-restart path)."""
        cache = cls(quantizer, capacity=capacity)
        cache.load(source, fingerprint=fingerprint)
        return cache
