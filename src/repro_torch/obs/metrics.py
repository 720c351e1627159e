"""Typed metrics: a mergeable log-bucket streaming histogram and a metric
registry with declared kinds.

The registry replaces ad-hoc counter-dict aggregation (and the old
suffix-keyed "these keys take max, not sum" special-casing in
``JaxBackend.extra_metrics``) with four explicit kinds:

  * ``counter``   — flow totals; merging **sums** them.
  * ``gauge``     — point-in-time / per-source layout properties (block
    bytes, capacity multipliers, quantization error); merging takes the
    **max** across sources, never the sum.
  * ``ratio``     — derived ``num_key / den_key`` over the *merged*
    counters (a token-weighted mean, not a mean of per-source ratios);
    declared as ``("ratio", num_key, den_key)`` in a kinds map.
  * ``histogram`` — a :class:`Histogram`; merging adds bucket counts, and
    the flat dict view emits ``<name>_p50/_p95/_p99`` fields.

A stat producer (e.g. ``PagedArmScheduler.STAT_KINDS``) declares the kind
per key once; consumers feed raw stat dicts through
:meth:`MetricRegistry.update` and read the aggregate via
:meth:`MetricRegistry.as_dict` — no per-call-site key lists.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple, Union

COUNTER = "counter"
GAUGE = "gauge"
RATIO = "ratio"
HISTOGRAM = "histogram"

#: a kinds map value: a kind name, or ("ratio", num_key, den_key)
Kind = Union[str, Tuple[str, str, str]]


class Histogram:
    """Fixed-log-bucket streaming histogram: O(1) observe, sparse counts,
    exact merge between same-layout histograms.

    Bucket ``i >= 1`` covers ``(lo * growth**(i-1), lo * growth**i]``;
    bucket 0 absorbs everything ``<= lo`` (zeros included).  A percentile
    answers with the geometric midpoint of its bucket clamped into the
    observed ``[min, max]`` range, so the relative error is bounded by
    ``sqrt(growth)`` — growth 1.12 keeps every quantile within ~6% while a
    thousand buckets span 12 orders of magnitude.
    """

    __slots__ = ("growth", "lo", "_log_g", "counts", "n", "total",
                 "vmin", "vmax")

    def __init__(self, growth: float = 1.12, lo: float = 1e-7):
        if growth <= 1.0:
            raise ValueError(f"growth must exceed 1.0, got {growth}")
        self.growth = growth
        self.lo = lo
        self._log_g = math.log(growth)
        self.counts: Dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _bucket(self, v: float) -> int:
        if v <= self.lo:
            return 0
        return 1 + int(math.log(v / self.lo) / self._log_g)

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            return
        i = self._bucket(v)
        self.counts[i] = self.counts.get(i, 0) + 1
        self.n += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def merge(self, other: "Histogram") -> "Histogram":
        """In-place exact merge — ``hist(A).merge(hist(B))`` is
        indistinguishable from ``hist(A + B)``.  Layouts must match."""
        if (other.growth, other.lo) != (self.growth, self.lo):
            raise ValueError(
                f"histogram layouts differ: ({self.growth}, {self.lo}) vs "
                f"({other.growth}, {other.lo})")
        for i, c in other.counts.items():
            self.counts[i] = self.counts.get(i, 0) + c
        self.n += other.n
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def percentile(self, q: float) -> float:
        """Inverted-CDF percentile, ``q`` in [0, 100]."""
        if self.n == 0:
            return 0.0
        rank = min(max(math.ceil(q / 100.0 * self.n), 1), self.n)
        cum = 0
        for i in sorted(self.counts):
            cum += self.counts[i]
            if cum >= rank:
                if i == 0:
                    rep = self.lo
                else:
                    # geometric midpoint of (lo*g^(i-1), lo*g^i]
                    rep = self.lo * self.growth ** (i - 0.5)
                return min(max(rep, self.vmin), self.vmax)
        return self.vmax                                  # pragma: no cover

    def summary(self, prefix: str, *, digits: int = 6) -> Dict[str, float]:
        """Flat ``{prefix_p50, prefix_p95, prefix_p99, prefix_mean,
        prefix_count}`` view (empty histogram -> empty dict)."""
        if self.n == 0:
            return {}
        return {
            f"{prefix}_p50": round(self.percentile(50), digits),
            f"{prefix}_p95": round(self.percentile(95), digits),
            f"{prefix}_p99": round(self.percentile(99), digits),
            f"{prefix}_mean": round(self.mean, digits),
            f"{prefix}_count": self.n,
        }


class MetricRegistry:
    """Kind-declared metric store with cross-source aggregation.

    ``update(stats, kinds)`` folds one producer's raw stat dict in under
    the declared kinds (unknown keys default to ``counter``); ``as_dict``
    renders the aggregate flat — ratios recomputed from merged counters,
    histograms expanded to percentile fields.  Declaring a key under two
    different kinds is a programming error and raises.
    """

    def __init__(self):
        self._kind: Dict[str, Kind] = {}
        self._val: Dict[str, object] = {}

    def _declare(self, name: str, kind: Kind) -> None:
        prev = self._kind.get(name)
        if prev is not None and prev != kind:
            raise ValueError(f"metric {name!r} redeclared: {prev} -> {kind}")
        self._kind[name] = kind

    # ------------------------------------------------------------- writers
    def counter(self, name: str, inc: float = 0) -> None:
        self._declare(name, COUNTER)
        self._val[name] = self._val.get(name, 0) + inc

    def gauge(self, name: str, value: float) -> None:
        """Max-merge across sources: per-source layout properties report
        the largest, never a meaningless sum."""
        self._declare(name, GAUGE)
        self._val[name] = max(self._val.get(name, value), value)

    def ratio(self, name: str, num_key: str, den_key: str) -> None:
        self._declare(name, (RATIO, num_key, den_key))

    def histogram(self, name: str, **hist_kw) -> Histogram:
        self._declare(name, HISTOGRAM)
        if name not in self._val:
            self._val[name] = Histogram(**hist_kw)
        return self._val[name]

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).observe(value)

    def update(self, stats: dict, kinds: Optional[Dict[str, Kind]] = None,
               *, default: str = COUNTER) -> None:
        """Fold one producer's stat dict in under its declared kinds."""
        kinds = kinds or {}
        for k, v in stats.items():
            kind = kinds.get(k, default)
            if isinstance(kind, tuple):
                self.ratio(k, kind[1], kind[2])
            elif kind == GAUGE:
                self.gauge(k, v)
            elif kind == HISTOGRAM:
                self.histogram(k).merge(v)
            else:
                self.counter(k, v)

    def merge(self, other: "MetricRegistry") -> "MetricRegistry":
        for name, kind in other._kind.items():
            if isinstance(kind, tuple):
                self.ratio(name, kind[1], kind[2])
            elif kind == GAUGE:
                self.gauge(name, other._val[name])
            elif kind == HISTOGRAM:
                self.histogram(name).merge(other._val[name])
            else:
                self.counter(name, other._val[name])
        return self

    # ------------------------------------------------------------- readers
    def kinds(self) -> Dict[str, Kind]:
        return dict(self._kind)

    def __contains__(self, name: str) -> bool:
        return name in self._kind

    def as_dict(self, *, digits: int = 4) -> dict:
        """Flat aggregate view: counters and gauges verbatim, ratios as
        rounded ``num/den`` over merged counters, histograms as
        ``_p50/_p95/_p99/_mean/_count`` fields."""
        out = {}
        for name, kind in self._kind.items():
            if isinstance(kind, tuple):
                num = self._val.get(kind[1], 0)
                den = self._val.get(kind[2], 0)
                out[name] = round(num / den, digits) if den else 0.0
            elif kind == HISTOGRAM:
                out.update(self._val[name].summary(name))
            else:
                out[name] = self._val[name]
        return out


def merge_stat_dicts(dicts: Iterable[dict],
                     kinds: Optional[Dict[str, Kind]] = None, *,
                     default: str = COUNTER, digits: int = 4) -> dict:
    """One-shot convenience: fold raw stat dicts through a fresh registry
    and return the flat aggregate."""
    reg = MetricRegistry()
    for d in dicts:
        reg.update(d, kinds, default=default)
    return reg.as_dict(digits=digits)
