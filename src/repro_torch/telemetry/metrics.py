"""Thread-safe metrics registry: named counters, gauges and histograms
(the port's copy of ``repro/telemetry/metrics.py``, names and
exposition unchanged, so ``GET /metrics`` serves the reference's
contract).

  * :class:`Counter` — monotone, ``inc(n)`` under a per-metric lock, so
    N threads incrementing concurrently always land exactly N;
  * :class:`Gauge` — last-write-wins scalar (``set``/``inc``/``dec``),
    with a ``set_max`` helper for high-water marks;
  * :class:`Histogram` — fixed cumulative buckets + count + sum, the
    Prometheus shape (service tier latencies, confidence distribution).

Metrics are identified by ``(name, labels)``; accessors are
get-or-create and idempotent, and a kind clash (``counter`` vs an
existing gauge of the same name) raises.  Exposition:
:meth:`MetricsRegistry.to_dict` (the service's ``stats`` block) and
:meth:`MetricsRegistry.render_prometheus` (text format v0.0.4);
:func:`parse_prometheus_text` is the strict scrape-side parser.

Metrics are always on: an increment is a lock and an add, a few per
sweep, never per iteration.  The process-default registry is
:data:`REGISTRY` (the port's own, separate from the reference's); the
module-level :func:`counter` / :func:`gauge` / :func:`histogram` helpers
target it.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Iterable, List, Optional, Tuple

#: default histogram buckets — latency-flavored seconds, wide enough for
#: both a sub-ms analytic probe and a multi-second escalation sweep
DEFAULT_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0)

LabelItems = Tuple[Tuple[str, str], ...]

#: Prometheus data-model identifiers (text format v0.0.4): metric names
#: may carry colons (recording rules), label names may not
_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _label_key(labels: Optional[Dict[str, str]]) -> LabelItems:
    if not labels:
        return ()
    items = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
    for k, _ in items:
        if not _LABEL_NAME_RE.match(k):
            raise ValueError(f"invalid Prometheus label name {k!r}")
    return items


def _escape_label_value(v: str) -> str:
    # text-format escaping for quoted label values: backslash, quote, LF
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(text: str) -> str:
    # HELP lines escape backslash and LF only (quotes are legal there)
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(items: LabelItems) -> str:
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label_value(v)}"'
                          for k, v in items) + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, labels: LabelItems, help: str):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid Prometheus metric name {name!r}")
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonically increasing integer-ish counter."""

    kind = "counter"

    def __init__(self, name, labels=(), help=""):
        super().__init__(name, labels, help)
        self._value = 0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def snapshot(self):
        return self.value


class Gauge(_Metric):
    """Last-write-wins scalar."""

    kind = "gauge"

    def __init__(self, name, labels=(), help=""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def set_max(self, v: float) -> None:
        """High-water-mark update: keep the larger of current and ``v``."""
        with self._lock:
            self._value = max(self._value, float(v))

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self):
        return self.value


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus shape)."""

    kind = "histogram"

    def __init__(self, name, labels=(), help="",
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, labels, help)
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError(f"histogram {name} needs >= 1 bucket bound")
        self._counts = [0] * (len(self.bounds) + 1)   # +inf tail
        self._sum = 0.0
        self._n = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._sum += v
            self._n += 1
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> Dict:
        with self._lock:
            cumulative, acc = [], 0
            for c in self._counts:
                acc += c
                cumulative.append(acc)
            return {
                "buckets": {str(b): cumulative[i]
                            for i, b in enumerate(self.bounds)},
                "+inf": cumulative[-1],
                "count": self._n,
                "sum": self._sum,
            }


class MetricsRegistry:
    """Get-or-create store of metrics, keyed by (name, labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelItems], _Metric] = {}

    def _get(self, cls, name: str, labels, help: str, **kw) -> _Metric:
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[1], help, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict] = None) -> Counter:
        return self._get(Counter, name, labels, help)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict] = None) -> Gauge:
        return self._get(Gauge, name, labels, help)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict] = None,
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, labels, help, buckets=buckets)

    def _items(self) -> List[Tuple[Tuple[str, LabelItems], _Metric]]:
        with self._lock:
            return sorted(self._metrics.items())

    def series(self, name: str) -> List[Tuple[Dict[str, str], object]]:
        """Every series of the family ``name``: ``[(labels, snapshot)]``."""
        return [(dict(labels), m.snapshot())
                for (n, labels), m in self._items() if n == name]

    def to_dict(self, prefix: str = "") -> Dict:
        """JSON-able snapshot ``{name{labels}: value-or-histogram}``,
        optionally filtered by name prefix."""
        out: Dict = {}
        for (name, labels), m in self._items():
            if prefix and not name.startswith(prefix):
                continue
            out[name + _label_str(labels)] = m.snapshot()
        return out

    def render_prometheus(self, prefix: str = "") -> str:
        """Prometheus text exposition format v0.0.4.

        Conformance details real scrapers depend on (what
        :func:`parse_prometheus_text` checks): one ``# TYPE``
        (and ``# HELP``, taken from any series that carries one) per
        metric family, emitted before its samples; label values escaped
        (backslash/quote/newline); histograms expose cumulative
        ``_bucket`` series including the ``+Inf`` bucket plus ``_sum``
        and ``_count``; a trailing newline ends the exposition."""
        # HELP can live on any series of a family (get-or-create sites
        # may pass it only once); resolve it family-wide first
        helps: Dict[str, str] = {}
        for (name, _), m in self._items():
            if m.help and name not in helps:
                helps[name] = m.help
        lines: List[str] = []
        seen_header = set()
        for (name, labels), m in self._items():
            if prefix and not name.startswith(prefix):
                continue
            if name not in seen_header:
                seen_header.add(name)
                if helps.get(name):
                    lines.append(
                        f"# HELP {name} {_escape_help(helps[name])}")
                lines.append(f"# TYPE {name} {m.kind}")
            ls = _label_str(labels)
            if isinstance(m, Histogram):
                snap = m.snapshot()
                base = dict(labels)
                for b, c in snap["buckets"].items():
                    lines.append(
                        f"{name}_bucket"
                        f"{_label_str(_label_key(dict(base, le=b)))} {c}")
                lines.append(
                    f"{name}_bucket"
                    f'{_label_str(_label_key(dict(base, le="+Inf")))} '
                    f'{snap["+inf"]}')
                lines.append(f"{name}_sum{ls} {snap['sum']}")
                lines.append(f"{name}_count{ls} {snap['count']}")
            else:
                lines.append(f"{name}{ls} {m.snapshot()}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Drop every metric — tests only; live handles held by modules
        keep counting into their (now unregistered) objects, so prefer
        delta assertions over reset in anything but isolated tests."""
        with self._lock:
            self._metrics.clear()


# ---------------------------------------------------------------------------
# strict text-format parser (conformance checking; the scrape-side dual
# of render_prometheus, used by the exposition tests and CI smoke)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>NaN|[+-]?Inf|[+-]?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)"
    r"(?: \d+)?$")                      # optional timestamp (ms)
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label_value(v: str) -> str:
    return (v.replace("\\n", "\n").replace('\\"', '"')
             .replace("\\\\", "\\"))


def _parse_labels(block: Optional[str]) -> Dict[str, str]:
    if not block:
        return {}
    pairs = _LABEL_PAIR_RE.findall(block)
    # the pairs must tile the whole block (separated by commas) — a
    # malformed remainder means a non-conformant line
    rebuilt = ",".join(f'{k}="{v}"' for k, v in pairs)
    if rebuilt != block.rstrip(","):
        raise ValueError(f"malformed label block {{{block}}}")
    return {k: _unescape_label_value(v) for k, v in pairs}


def _family_of(sample_name: str, types: Dict[str, str]) -> Optional[str]:
    if sample_name in types:
        return sample_name
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            if types.get(base) == "histogram":
                return base
    return None


def parse_prometheus_text(text: str) -> Dict[str, Dict]:
    """Strictly parse Prometheus text format v0.0.4; raises ValueError on
    any non-conformance a real scraper would reject (or silently
    mis-read).  Returns ``{family: {"type", "help", "samples":
    [(sample_name, labels, value), ...]}}``.

    Beyond line syntax, this validates the invariants scrape pipelines
    assume: ``# TYPE`` precedes its family's samples and appears at most
    once; histogram families expose cumulative monotone ``_bucket``
    series whose ``+Inf`` bucket equals ``_count``, plus a ``_sum``;
    counters never carry a negative value."""
    if text and not text.endswith("\n"):
        raise ValueError("exposition must end with a newline")
    families: Dict[str, Dict] = {}
    types: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(" ", 1)
            name = parts[0]
            fam = families.setdefault(
                name, {"type": None, "help": None, "samples": []})
            fam["help"] = parts[1] if len(parts) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split(" ")
            if len(parts) != 2:
                raise ValueError(f"line {lineno}: malformed TYPE: {line!r}")
            name, kind = parts
            if kind not in ("counter", "gauge", "histogram", "summary",
                            "untyped"):
                raise ValueError(f"line {lineno}: unknown type {kind!r}")
            if name in types:
                raise ValueError(f"line {lineno}: duplicate TYPE for "
                                 f"{name!r}")
            fam = families.setdefault(
                name, {"type": None, "help": None, "samples": []})
            if fam["samples"]:
                raise ValueError(f"line {lineno}: TYPE for {name!r} after "
                                 f"its samples")
            fam["type"] = kind
            types[name] = kind
            continue
        if line.startswith("#"):
            continue                               # free-form comment
        mt = _SAMPLE_RE.match(line)
        if mt is None:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        sample_name = mt.group("name")
        labels = _parse_labels(mt.group("labels"))
        value = float(mt.group("value"))
        family = _family_of(sample_name, types)
        if family is None:
            raise ValueError(f"line {lineno}: sample {sample_name!r} has "
                             f"no preceding # TYPE")
        if types[family] == "counter" and value < 0:
            raise ValueError(f"line {lineno}: counter {sample_name!r} "
                             f"is negative ({value})")
        families[family]["samples"].append((sample_name, labels, value))

    for name, fam in families.items():
        if fam["type"] != "histogram":
            continue
        series: Dict[LabelItems, Dict] = {}
        for sample_name, labels, value in fam["samples"]:
            base = tuple(sorted((k, v) for k, v in labels.items()
                                if k != "le"))
            s = series.setdefault(base, {"buckets": [], "sum": None,
                                         "count": None})
            if sample_name == name + "_bucket":
                if "le" not in labels:
                    raise ValueError(f"{name}_bucket missing le label")
                s["buckets"].append((labels["le"], value))
            elif sample_name == name + "_sum":
                s["sum"] = value
            elif sample_name == name + "_count":
                s["count"] = value
        for base, s in series.items():
            if s["sum"] is None or s["count"] is None:
                raise ValueError(f"histogram {name}{dict(base)} missing "
                                 f"_sum or _count")
            bounds = [float(le) for le, _ in s["buckets"]]
            if not bounds or bounds != sorted(bounds):
                raise ValueError(f"histogram {name}{dict(base)} buckets "
                                 f"out of order: {bounds}")
            counts = [c for _, c in s["buckets"]]
            if any(b > a for b, a in zip(counts, counts[1:])):
                raise ValueError(f"histogram {name}{dict(base)} bucket "
                                 f"counts not cumulative: {counts}")
            if s["buckets"][-1][0] != "+Inf":
                raise ValueError(f"histogram {name}{dict(base)} missing "
                                 f"+Inf bucket")
            if counts[-1] != s["count"]:
                raise ValueError(f"histogram {name}{dict(base)} +Inf "
                                 f"bucket {counts[-1]} != _count "
                                 f"{s['count']}")
    return families


#: the process-default registry every instrumented module targets
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "",
            labels: Optional[Dict] = None) -> Counter:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Optional[Dict] = None) -> Gauge:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Optional[Dict] = None,
              buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labels, buckets)
