"""Prometheus-exposition metrics for the serving stack (stdlib only).

Port of ltx_tpu/serve/metrics.py, the same metric names, label sets,
buckets and text: counters, histograms with cumulative buckets and callback
gauges, all thread-safe, rendered without prometheus_client.

Scrape with `GET /metrics` (also `/v1/metrics`)."""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

# Latency buckets from a decode forward's milliseconds through enhance
# batches of seconds to generations of minutes.
LATENCY_BUCKETS = (0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0, 120.0, 300.0, 600.0, math.inf)


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _labels_str(names: Sequence[str], values: Tuple[str, ...],
                extra: str = "") -> str:
    parts = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n")


class Counter:
    """Monotone counter, optionally labelled."""

    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(str(labels.get(n, "")) for n in self.labelnames)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = tuple(str(labels.get(n, "")) for n in self.labelnames)
        with self._lock:
            return self._values.get(key, 0.0)

    def render(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            yield f"{self.name}{_labels_str(self.labelnames, key)} {_fmt(v)}"


class Gauge:
    """Gauge whose value is read at scrape time from a callback (for
    queue depths owned by other components) or set explicitly."""

    kind = "gauge"

    def __init__(self, name: str, help: str,
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self._fn = fn
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def render(self) -> Iterable[str]:
        if self._fn is not None:
            try:
                v = float(self._fn())
            except Exception:  # noqa: BLE001 — a scrape must never fail
                v = float("nan")
        else:
            with self._lock:
                v = self._value
        yield f"{self.name} {_fmt(v) if v == v else 'NaN'}"


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics), labelled."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        bs = tuple(sorted(buckets))
        self.buckets = bs if bs and bs[-1] == math.inf else bs + (math.inf,)
        self._lock = threading.Lock()
        # key -> [counts per bucket, sum, count]
        self._series: Dict[Tuple[str, ...], list] = {}

    def observe(self, v: float, **labels) -> None:
        key = tuple(str(labels.get(n, "")) for n in self.labelnames)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = [[0] * len(self.buckets), 0.0, 0]
                self._series[key] = s
            for i, b in enumerate(self.buckets):
                if v <= b:
                    s[0][i] += 1
                    break
            s[1] += v
            s[2] += 1

    def summary(self, **labels) -> Tuple[int, float]:
        """(count, sum) for one label set — test/stats convenience."""
        key = tuple(str(labels.get(n, "")) for n in self.labelnames)
        with self._lock:
            s = self._series.get(key)
            return (s[2], s[1]) if s else (0, 0.0)

    def render(self) -> Iterable[str]:
        with self._lock:
            items = [(k, [list(s[0]), s[1], s[2]])
                     for k, s in sorted(self._series.items())]
        for key, (counts, total, n) in items:
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                le = f'le="{_fmt(b)}"'
                yield (f"{self.name}_bucket"
                       f"{_labels_str(self.labelnames, key, le)} {cum}")
            yield f"{self.name}_sum{_labels_str(self.labelnames, key)} " \
                  f"{repr(float(total))}"
            yield f"{self.name}_count{_labels_str(self.labelnames, key)} {n}"


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: list = []

    def register(self, metric):
        with self._lock:
            self._metrics.append(metric)
        return metric

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics)
        lines = []
        for m in metrics:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


class ServeMetrics:
    """The serving stack's metric set, wired by serve/app.py."""

    def __init__(self):
        self.registry = Registry()
        r = self.registry.register
        self.http_requests_total = r(Counter(
            "ltx_http_requests_total", "HTTP requests by route/method/code",
            ("route", "method", "code")))
        self.http_request_seconds = r(Histogram(
            "ltx_http_request_seconds", "HTTP request wall time", ("route",)))
        self.enhance_batch_seconds = r(Histogram(
            "ltx_enhance_batch_seconds",
            "Coalesced enhance batch device time"))
        self.enhance_rows_total = r(Counter(
            "ltx_enhance_rows_total", "Enhance rows by outcome",
            ("outcome",)))
        self.job_seconds = r(Histogram(
            "ltx_job_seconds", "Generation job run time by kind/state",
            ("kind", "state")))

    # hooks with the exact callback signatures batcher/jobs expose

    def on_batch(self, seconds: float, size: int, ok: bool) -> None:
        self.enhance_batch_seconds.observe(seconds)
        self.enhance_rows_total.inc(size, outcome="done" if ok else "failed")

    def on_job(self, kind: str, state: str, seconds: float) -> None:
        self.job_seconds.observe(seconds, kind=kind, state=state)

    def gauge(self, name: str, help: str, fn: Callable[[], float]) -> Gauge:
        return self.registry.register(Gauge(name, help, fn))
