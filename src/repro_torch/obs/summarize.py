"""Aggregate + validate repro-obs trace files (either package's).

``python -m repro_torch.obs summarize out.json`` prints a per-span-name table
(count, total/mean/min/max wall ms, share of the root span) plus the
embedded metrics snapshot. ``python -m repro_torch.obs validate out.json
--require dataset partition train classifier`` is the CI gate: it checks
the document parses as Chrome trace-event JSON with the repro schema
marker and that every required name matches at least one span
(``--require partition`` accepts a ``partition`` category, any
``partition.*`` span, or any ``*.partition`` span — so the mandatory
pipeline-stage set can be named without the ``pipeline.`` prefix).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence

__all__ = ["load_trace", "validate_trace", "summarize_trace",
           "format_summary"]


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _complete_events(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]


def validate_trace(doc: Dict[str, Any],
                   require: Sequence[str] = ()) -> List[str]:
    """Return a list of problems (empty == valid)."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["trace document is not a JSON object"]
    if doc.get("schema") != "repro-obs-trace":
        problems.append("missing schema marker 'repro-obs-trace'")
    if not isinstance(doc.get("version"), int):
        problems.append("missing integer 'version'")
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        problems.append("'traceEvents' missing or empty")
        return problems
    for i, e in enumerate(events):
        if not isinstance(e, dict) or "ph" not in e:
            problems.append(f"event {i} is not a trace event (no 'ph')")
            continue
        if e["ph"] == "X":
            for field in ("name", "ts", "dur", "pid", "tid"):
                if field not in e:
                    problems.append(f"event {i} ({e.get('name')!r}) "
                                    f"missing {field!r}")
            if isinstance(e.get("dur"), (int, float)) and e["dur"] < 0:
                problems.append(f"event {i} has negative dur")
    complete = _complete_events(doc)
    if not complete:
        problems.append("no complete (ph='X') span events")
    names = {e.get("name", "") for e in complete}
    cats = {e.get("cat", "") for e in complete}
    for req in require:
        if req in names or req in cats or any(
                n.startswith(req + ".") or n.endswith("." + req)
                for n in names):
            continue
        problems.append(f"required span {req!r} not present")
    return problems


def summarize_trace(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per-span-name aggregates, sorted by total time descending."""
    agg: Dict[str, Dict[str, Any]] = {}
    total_wall_us = 0.0
    for e in _complete_events(doc):
        dur = float(e.get("dur", 0.0))
        row = agg.setdefault(e["name"], {
            "name": e["name"], "count": 0, "total_us": 0.0,
            "min_us": None, "max_us": 0.0})
        row["count"] += 1
        row["total_us"] += dur
        row["max_us"] = max(row["max_us"], dur)
        row["min_us"] = dur if row["min_us"] is None else min(
            row["min_us"], dur)
        # Depth-0 spans partition wall time; their sum is the run's wall.
        if e.get("args", {}).get("depth") == 0:
            total_wall_us += dur
    rows = sorted(agg.values(), key=lambda r: -r["total_us"])
    for r in rows:
        r["mean_us"] = r["total_us"] / r["count"]
        r["share"] = (r["total_us"] / total_wall_us) if total_wall_us else 0.0
    return rows


def format_summary(doc: Dict[str, Any], top: int = 0) -> str:
    rows = summarize_trace(doc)
    if top:
        rows = rows[:top]
    lines = [f"{'span':<34s} {'count':>7s} {'total ms':>10s} "
             f"{'mean ms':>9s} {'min ms':>9s} {'max ms':>9s} {'share':>6s}"]
    lines.append("-" * len(lines[0]))
    for r in rows:
        lines.append(
            f"{r['name']:<34s} {r['count']:>7d} "
            f"{r['total_us'] / 1000:>10.2f} {r['mean_us'] / 1000:>9.3f} "
            f"{r['min_us'] / 1000:>9.3f} {r['max_us'] / 1000:>9.3f} "
            f"{r['share'] * 100:>5.1f}%")
    metrics = doc.get("metrics") or {}
    if metrics:
        lines.append("")
        lines.append(f"{'metric':<44s} {'kind':<10s} value")
        lines.append("-" * 72)
        for name, m in metrics.items():
            val = m.get("value")
            if isinstance(val, dict):   # histogram: compact one-liner
                val = (f"count={val.get('count')} sum={val.get('sum'):.6g} "
                       f"min={val.get('min')} max={val.get('max')}")
            lines.append(f"{name:<44s} {m.get('kind', ''):<10s} {val}")
    if "droppedEvents" in doc:
        lines.append("")
        lines.append(f"warning: {doc['droppedEvents']} events dropped "
                     f"(trace buffer cap)")
    return "\n".join(lines)
