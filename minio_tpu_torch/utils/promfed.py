"""Federated Prometheus exposition: parse + cluster-wide merge.

The reference aggregates every node's metrics into one scrape at
``/minio/v2/metrics/cluster`` (cmd/metrics-v2.go): Prometheus sees ONE
endpoint instead of N, and the operator's dashboards need no per-node
relabeling. Here the admin ``GET /minio/admin/v3/metrics?cluster=1``
fans out over peer RPC for each node's text exposition and merges them
with these rules:

  * **counters** are SUMMED per label set across nodes (`rate()` over
    the merged family is the cluster rate — a `node` label would force
    every dashboard to `sum by ()` first);
  * **gauges** carry a ``node`` label per origin (summing instantaneous
    values like queue depth across nodes destroys the signal an
    operator pages on — WHICH node is saturated);
  * **histograms** merge BUCKET-WISE: per label set, each `le` bucket's
    cumulative count, `_sum` and `_count` are summed across nodes
    (cluster-wide quantiles stay computable; nodes share code so bucket
    edges agree, and a disagreeing edge simply contributes its own `le`
    series — cumulative counts remain monotone per node-set);
  * **untyped** families are treated like gauges (origin matters when
    the kind is unknown).

A copy of minio_tpu/utils/promfed.py (host only, standard library only).

Parsing is deliberately tolerant: a malformed line from a peer drops
that line, never the scrape — a degraded merge beats a failed one.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

__all__ = ["ParsedFamily", "parse_exposition", "merge_expositions"]

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


_UNESCAPE_RE = re.compile(r"\\(.)")
_UNESCAPE_MAP = {"n": "\n", '"': '"', "\\": "\\"}


def _unescape(v: str) -> str:
    # single pass: sequential .replace() corrupts values containing a
    # backslash (the '\\' pair's second byte + 'n' would read as '\n')
    return _UNESCAPE_RE.sub(
        lambda m: _UNESCAPE_MAP.get(m.group(1), "\\" + m.group(1)), v)


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _parse_value(s: str) -> Optional[float]:
    if s == "+Inf":
        return float("inf")
    if s == "-Inf":
        return float("-inf")
    try:
        return float(s)
    except ValueError:
        return None


class ParsedFamily:
    """One family from a text exposition: kind, help, and samples as
    (sample_name, label_key_tuple) -> value."""

    __slots__ = ("name", "kind", "help", "samples")

    def __init__(self, name: str):
        self.name = name
        self.kind = "untyped"
        self.help = ""
        self.samples: Dict[Tuple[str, tuple], float] = {}


def _family_of(name: str, fams: Dict[str, ParsedFamily]
               ) -> Optional[str]:
    """Map a sample name to its family: exact, or histogram suffix."""
    if name in fams:
        return name
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            base = name[: -len(suffix)]
            if base in fams and fams[base].kind == "histogram":
                return base
    return None


def parse_exposition(text: str) -> Dict[str, ParsedFamily]:
    """Text exposition -> {family name: ParsedFamily}. Samples whose
    family never declared a # TYPE get an untyped family of their own
    name; malformed lines are skipped."""
    fams: Dict[str, ParsedFamily] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) >= 3:
                fam = fams.setdefault(parts[2], ParsedFamily(parts[2]))
                fam.help = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) >= 4:
                fam = fams.setdefault(parts[2], ParsedFamily(parts[2]))
                fam.kind = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        value = _parse_value(m.group("value"))
        if value is None:
            continue
        name = m.group("name")
        labels = tuple(sorted(
            (k, _unescape(v))
            for k, v in _LABEL_RE.findall(m.group("labels") or "")))
        fam_name = _family_of(name, fams)
        if fam_name is None:
            fam_name = name
            fams.setdefault(name, ParsedFamily(name))
        fams[fam_name].samples[(name, labels)] = value
    return fams


def _render_labels(labels: tuple) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape(str(v))}"'
                          for k, v in labels) + "}"


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def merge_expositions(nodes: List[Tuple[str, str]]) -> str:
    """Merge per-node text expositions into one cluster exposition.

    ``nodes`` is [(node_name, exposition_text)]; the first entry is
    conventionally the serving node. Counters sum, gauges/untyped gain
    a ``node`` label, histograms merge bucket-wise (see module doc).
    """
    merged: Dict[str, ParsedFamily] = {}
    for node, text in nodes:
        for name, fam in parse_exposition(text).items():
            out = merged.get(name)
            if out is None:
                out = merged[name] = ParsedFamily(name)
                out.kind = fam.kind
                out.help = fam.help
            elif out.kind == "untyped" and fam.kind != "untyped":
                out.kind = fam.kind
                out.help = out.help or fam.help
            for (sname, labels), value in fam.samples.items():
                if out.kind in ("counter", "histogram"):
                    key = (sname, labels)
                    out.samples[key] = out.samples.get(key, 0) + value
                else:
                    key = (sname, tuple(sorted(
                        labels + (("node", node),))))
                    out.samples[key] = value
    lines: List[str] = []
    for fam in sorted(merged.values(), key=lambda f: f.name):
        lines.append(f"# HELP {fam.name} {fam.help}".rstrip())
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for (sname, labels), value in sorted(fam.samples.items(),
                                             key=_sample_sort_key):
            lines.append(f"{sname}{_render_labels(labels)} {_fmt(value)}")
    return "\n".join(lines) + "\n"


def _sample_sort_key(item):
    """Stable sample order with histogram buckets ascending by `le`
    (lexical label sort would put +Inf first and unsorted buckets
    confuse scrapers): group by the non-le labels, then bucket series
    numerically, then _sum/_count after the buckets."""
    (sname, labels), _value = item
    le = None
    rest = []
    for k, v in labels:
        if k == "le":
            le = _parse_value(v)
        else:
            rest.append((k, v))
    order = 1 if le is not None else 2
    return (sname.rsplit("_bucket", 1)[0], tuple(rest), order,
            le if le is not None else 0.0, sname)
