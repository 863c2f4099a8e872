"""Metrics registry: counters, gauges and bounded reservoir histograms
registered by name and label set, rendered as plain dicts (``snapshot()`` /
``series()``) or as Prometheus text exposition (``render_prometheus()``).
A copy of the JAX package's jax-free ``obs/metrics.py``, so the port
imports nothing of that package; :meth:`~raft_stereo_tpu_torch.obs.ledger.
ProgramLedger.attribution` reads its counters.

Design points:

- **bounded by construction**: histograms keep a fixed-size sample — a
  sliding window of the newest N (the latency default: percentiles must
  react to a FRESH regression on a long-running server) or a uniform
  lifetime reservoir (Vitter's algorithm R, deterministic per-instrument
  seed) — so latency tracking is O(1) memory at any request count; the
  bound is the type;
- **get-or-create**: ``counter(name, **labels)`` returns the existing
  instrument for an existing (name, labels) pair — a scheduler rebuilt on
  service restart keeps accumulating instead of double-registering;
  re-registering a name as a different instrument type is an error;
- **stdlib only**: importable from host-side tooling without torch.

Percentiles are ``sorted(sample)[min(n-1, int(p*n))]``.
"""

from __future__ import annotations

import random
import re
import threading
import time
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

#: Captured once at first import: the registry's view of "when this
#: process started" (standard exposition practice —
#: ``process_start_time_seconds`` lets a scraper detect restarts and
#: rate-window counters correctly). Close enough to exec time for any
#: serving process, with no /proc parsing or third-party dependency.
_PROCESS_START_S = time.time()

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Default reservoir size for histograms — matches the 512-sample sliding
#: windows the serving layer used before the registry existed.
DEFAULT_RESERVOIR = 512


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render as integers so
    counters read naturally; everything else as repr (full precision)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    """Exposition-format label value escaping: backslash FIRST (or the
    escapes it introduces would be re-escaped), then newline and quote —
    a hostile label value must round-trip through a scraper, not corrupt
    the line protocol (golden-pinned in tests/test_obs.py)."""
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _escape_help(v: str) -> str:
    """HELP-line escaping per the exposition format: backslash and
    newline only (quotes are legal in help text)."""
    return v.replace("\\", r"\\").replace("\n", r"\n")


class Counter:
    """Monotonic float counter (``inc`` only — a value that can go down
    is a :class:`Gauge`)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-size sample + exact count/sum/min/max. Two sampling modes,
    both O(size) memory forever (the long-run memory pin in
    tests/test_obs.py):

    - ``"window"`` (the latency default): the most RECENT ``size``
      observations — byte-identical semantics to the sliding deques this
      replaced, so /healthz p50/p99 keep reacting to a fresh latency
      regression on a long-running server (a lifetime-uniform sample
      would dilute a new regression to invisibility after enough
      history);
    - ``"reservoir"``: Vitter's algorithm R, an unbiased uniform sample
      over ALL observations — the right view for lifetime distributions.
      The RNG is seeded from the instrument identity (crc32, not the
      salted ``hash``) so a replayed test sees the same sample on every
      run.
    """

    __slots__ = ("name", "labels", "size", "mode", "_sample", "_count",
                 "_sum", "_min", "_max", "_rng", "_lock")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 size: int = DEFAULT_RESERVOIR, mode: str = "window"):
        if size < 1:
            raise ValueError(f"histogram {name}: reservoir size must be "
                             f">= 1, got {size}")
        if mode not in ("window", "reservoir"):
            raise ValueError(f"histogram {name}: unknown mode {mode!r}")
        self.name = name
        self.labels = labels
        self.size = size
        self.mode = mode
        self._sample: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._rng = random.Random(zlib.crc32(repr((name, labels)).encode()))
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            if len(self._sample) < self.size:
                self._sample.append(v)
            elif self.mode == "window":
                # ring overwrite: the sample is always the newest `size`
                self._sample[(self._count - 1) % self.size] = v
            else:
                j = self._rng.randrange(self._count)
                if j < self.size:
                    self._sample[j] = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def n(self) -> int:
        """Current sample size (== count until the reservoir saturates) —
        the ``n`` the /healthz latency document reports."""
        with self._lock:
            return len(self._sample)

    def percentile(self, p: float) -> Optional[float]:
        """``sorted(sample)[min(n-1, int(p*n))]`` — the exact formula the
        pre-registry sliding windows used, so /healthz p50/p99 are
        byte-identical at equal sample counts."""
        with self._lock:
            sample = sorted(self._sample)
        if not sample:
            return None
        return sample[min(len(sample) - 1, int(p * len(sample)))]

    def stats(self) -> Dict:
        with self._lock:
            return {"count": self._count, "sum": self._sum,
                    "min": self._min, "max": self._max,
                    "sample_n": len(self._sample)}


class MetricsRegistry:
    """Named instrument store with label support and two renderings.

    One registry per serving process (the session owns it; service and
    scheduler share it), so /healthz and /metrics describe the same
    counters by construction.
    """

    #: Prometheus summary quantiles rendered for every histogram.
    QUANTILES = (0.5, 0.9, 0.99)

    def __init__(self):
        self._instruments: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                                object] = {}
        self._meta: Dict[str, Tuple[type, str]] = {}  # name -> (type, help)
        self._lock = threading.Lock()

    # -- registration ------------------------------------------------------

    def _get(self, cls, name: str, help: str,
             labels: Dict[str, str], **extra):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r} on {name}")
        lab = tuple(sorted((k, str(v)) for k, v in labels.items()))
        key = (name, lab)
        with self._lock:
            inst = self._instruments.get(key)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(inst).__name__}, not {cls.__name__}")
                return inst
            prev = self._meta.get(name)
            if prev is not None and prev[0] is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{prev[0].__name__}, not {cls.__name__}")
            inst = cls(name, lab, **extra)
            self._instruments[key] = inst
            if prev is None or (help and not prev[1]):
                self._meta[name] = (cls, help or (prev[1] if prev else ""))
            return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  reservoir: int = DEFAULT_RESERVOIR,
                  mode: str = "window", **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, size=reservoir,
                         mode=mode)

    def set_build_info(self, **labels) -> None:
        """Standard exposition identity: ``raft_build_info`` (value
        always 1 — the information is the LABELS: config fingerprint,
        python/torch versions, backend) plus
        ``raft_process_start_time_seconds``, so every scrape identifies
        exactly what is running and when it came up.  Get-or-create like
        every other instrument: re-registering the same identity is a
        no-op, a new identity (fresh session) adds its own series."""
        self.gauge(
            "raft_build_info",
            "identity of the running build/config (value is always 1; "
            "the labels carry the information)",
            **{k: str(v) for k, v in labels.items()}).set(1.0)
        self.gauge(
            "raft_process_start_time_seconds",
            "unix time this process started (metrics-module import "
            "time)").set(_PROCESS_START_S)

    # -- queries -----------------------------------------------------------

    def series(self, name: str) -> List[Tuple[Dict[str, str], float]]:
        """All (labels, value) pairs of one counter/gauge family — the
        /healthz folding primitive (e.g. the request-outcome map)."""
        with self._lock:
            insts = [i for (n, _), i in self._instruments.items()
                     if n == name]
        return [(dict(i.labels), i.value) for i in insts
                if isinstance(i, (Counter, Gauge))]

    def value(self, name: str, **labels) -> float:
        """Value of one counter/gauge, 0.0 when never registered."""
        lab = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            inst = self._instruments.get((name, lab))
        if inst is None:
            return 0.0
        if isinstance(inst, Histogram):
            raise TypeError(f"{name} is a histogram; use series/stats")
        return inst.value

    def snapshot(self) -> Dict:
        """Plain-dict dump of every instrument (JSON-able; the /healthz
        derivation surface)."""
        with self._lock:
            items = sorted(self._instruments.items())
            meta = dict(self._meta)
        out: Dict = {}
        for (name, lab), inst in items:
            fam = out.setdefault(name, {
                "type": meta[name][0].__name__.lower(),
                "help": meta[name][1], "series": []})
            entry: Dict = {"labels": dict(lab)}
            if isinstance(inst, Histogram):
                entry.update(inst.stats())
                entry["p50"] = inst.percentile(0.50)
                entry["p99"] = inst.percentile(0.99)
            else:
                entry["value"] = inst.value
            fam["series"].append(entry)
        return out

    # -- Prometheus exposition --------------------------------------------

    @staticmethod
    def _label_str(labels: Iterable[Tuple[str, str]]) -> str:
        parts = [f'{k}="{_escape_label(v)}"' for k, v in labels]
        return "{%s}" % ",".join(parts) if parts else ""

    def render_prometheus(self) -> str:
        """Text exposition format (version 0.0.4): counters and gauges as
        themselves, reservoir histograms as summaries (quantile series +
        ``_sum``/``_count``)."""
        with self._lock:
            items = sorted(self._instruments.items())
            meta = dict(self._meta)
        lines: List[str] = []
        seen_header = set()
        for (name, lab), inst in items:
            if name not in seen_header:
                seen_header.add(name)
                cls, help_text = meta[name]
                kind = {"Counter": "counter", "Gauge": "gauge",
                        "Histogram": "summary"}[cls.__name__]
                if help_text:
                    lines.append(f"# HELP {name} {_escape_help(help_text)}")
                lines.append(f"# TYPE {name} {kind}")
            if isinstance(inst, Histogram):
                for q in self.QUANTILES:
                    v = inst.percentile(q)
                    qlab = lab + (("quantile", _fmt(q)),)
                    lines.append(
                        f"{name}{self._label_str(qlab)} "
                        f"{_fmt(v) if v is not None else 'NaN'}")
                lines.append(f"{name}_sum{self._label_str(lab)} "
                             f"{_fmt(inst.sum)}")
                lines.append(f"{name}_count{self._label_str(lab)} "
                             f"{_fmt(inst.count)}")
            else:
                lines.append(
                    f"{name}{self._label_str(lab)} {_fmt(inst.value)}")
        return "\n".join(lines) + ("\n" if lines else "")
