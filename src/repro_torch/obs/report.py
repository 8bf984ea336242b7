"""Cross-run bench observatory: trend report + robust drift detection.

The bench ledger (`experiments/bench_history.jsonl`, one JSONL entry
per (run, row)) is the repo's long-horizon perf memory — the paper's
10%-mean / 20%-max speedup claims are only trustworthy if they hold run
over run.  This module, the port's copy of the JAX package's
`obs.report`, turns the ledger into:

- `detect_all` / `detect_series` — a robust MAD (median absolute
  deviation) changepoint/drift detector over every (row, metric)
  series.  Medians and MAD instead of mean/stddev: a single outlier
  run must neither trigger nor mask a real shift.  Two finding kinds:

  * ``drift``       — the latest value's robust z-score against the
    history before it exceeds ``threshold``;
  * ``changepoint`` — some split of the series separates two segments
    whose medians differ by more than ``threshold`` robust scales
    (a sustained level shift, not just a bad last run).

  ``python -m repro_torch.launch.history --detect`` exits non-zero when
  any series is flagged.  Wall-time (``us_per_call``) series are
  *rendered* but not *gated* by default — machine-to-machine wall noise
  must not fail CI; pass ``include_wall=True`` (``--include-wall``) to
  gate them too.

- `build_html` / `write_html` — a self-contained static HTML report:
  one section per row with inline-SVG trend charts per metric, the
  wall-time trajectory, flagged points marked, and a per-entry table
  (UTC timestamp, wall time, derived string, provenance config hash).
  No JavaScript, no external assets, byte-deterministic for the same
  inputs.

Everything here is **pure stdlib** (like `repro_torch.lint`): the
observatory must be able to judge a checkout where the scientific stack
is broken — that is precisely when you need it.  It imports nothing of
numpy or torch, so it also loads by path alone.  Loading the ledger
itself stays in `repro_torch.launch.history` (`load_history`); this
module only transforms already-parsed entries.
"""

from __future__ import annotations

import datetime
import html as _html
import math
from statistics import median
from typing import Dict, List, Optional, Tuple

#: metric key under which an entry's wall time is folded into the
#: series map (distinct from any parse_derived key, which never starts
#: with an underscore-free "us_" today but keep it collision-proof)
WALL_METRIC = "us_per_call"

#: detector defaults: 4 robust scales, at least 5 points of history
DEFAULT_THRESHOLD = 4.0
DEFAULT_MIN_POINTS = 5
#: MAD floor, relative to the series median: a perfectly constant
#: history gets a tiny tolerance band instead of a zero one, so exact
#: repeats stay clean while any genuine move is (correctly) flagged
REL_FLOOR = 1e-9


# ---------------------------------------------------------------------------
# series extraction
# ---------------------------------------------------------------------------

def history_series(entries: List[dict]
                   ) -> Dict[Tuple[str, str], List[dict]]:
    """(row, metric) -> chronological points ``{ts, value, hash}``.

    Includes each entry's wall time as metric `WALL_METRIC`.  Entries
    without a ``row`` or with non-numeric values are skipped — the
    ledger's torn-line tolerance extends to torn fields.
    """
    out: Dict[Tuple[str, str], List[dict]] = {}

    def push(row: str, metric: str, value, e: dict) -> None:
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        if not math.isfinite(v):
            return
        out.setdefault((row, metric), []).append(
            {"ts": float(e.get("ts") or 0.0), "value": v,
             "hash": str(e.get("hash", ""))})

    for e in entries:
        row = e.get("row")
        if not row:
            continue
        if "us_per_call" in e:
            push(row, WALL_METRIC, e["us_per_call"], e)
        for k, v in (e.get("metrics") or {}).items():
            push(row, k, v, e)
    return out


# ---------------------------------------------------------------------------
# robust detection
# ---------------------------------------------------------------------------

def _mad(values: List[float], center: Optional[float] = None) -> float:
    """Median absolute deviation (unscaled)."""
    if not values:
        return 0.0
    c = median(values) if center is None else center
    return median([abs(v - c) for v in values])


def _scale(values: List[float], center: Optional[float] = None) -> float:
    """MAD as a robust sigma (x1.4826, the normal-consistency factor),
    floored relative to the median so constant series keep a band."""
    c = median(values) if center is None else center
    return max(1.4826 * _mad(values, c), REL_FLOOR * max(abs(c), 1.0))


def detect_series(values: List[float],
                  threshold: float = DEFAULT_THRESHOLD,
                  min_points: int = DEFAULT_MIN_POINTS,
                  min_segment: int = 3) -> List[dict]:
    """Findings for one chronological series (empty list = clean).

    - ``drift``: robust z-score of the last point against all earlier
      points exceeds ``threshold``.
    - ``changepoint``: the best split into two segments (each at least
      ``min_segment`` long) separates medians by more than
      ``threshold`` robust scales; the reported index is the first
      point of the new level.

    Series shorter than ``min_points`` are skipped — a young ledger
    (including the single committed seed entry) is always clean.
    """
    n = len(values)
    if n < min_points:
        return []
    findings = []
    head, last = values[:-1], values[-1]
    med = median(head)
    z = abs(last - med) / _scale(head, med)
    if z > threshold:
        findings.append({"kind": "drift", "index": n - 1, "value": last,
                         "baseline": med, "score": z})
    best = None
    best_cost = math.inf
    for k in range(min_segment, n - min_segment + 1):
        left, right = values[:k], values[k:]
        ml, mr = median(left), median(right)
        spread = max(_scale(left, ml), _scale(right, mr))
        score = abs(mr - ml) / spread
        if score <= threshold:
            continue
        # among above-threshold splits, place the boundary where the
        # two segments are most internally homogeneous (robust L1
        # cost); raw score alone ties on flat segments and would put
        # the boundary at the first admissible split
        cost = (sum(abs(v - ml) for v in left)
                + sum(abs(v - mr) for v in right))
        if best is None or cost < best_cost or (cost == best_cost
                                                and score > best["score"]):
            best = {"kind": "changepoint", "index": k, "value": mr,
                    "baseline": ml, "score": score}
            best_cost = cost
    if best is not None:
        findings.append(best)
    return findings


def detect_all(entries: List[dict],
               threshold: float = DEFAULT_THRESHOLD,
               min_points: int = DEFAULT_MIN_POINTS,
               include_wall: bool = False) -> List[dict]:
    """Detector over every (row, metric) series of the ledger.

    Returns one finding dict per flagged (series, kind):
    ``{row, metric, kind, index, ts, hash, value, baseline, score}``.
    Wall-time series are excluded unless ``include_wall`` (see module
    docstring).
    """
    findings = []
    for (row, metric), pts in sorted(history_series(entries).items()):
        if metric == WALL_METRIC and not include_wall:
            continue
        for f in detect_series([p["value"] for p in pts], threshold,
                               min_points):
            at = pts[f["index"]]
            findings.append(dict(f, row=row, metric=metric,
                                 ts=at["ts"], hash=at["hash"]))
    findings.sort(key=lambda f: -f["score"])
    return findings


def format_findings(findings: List[dict]) -> str:
    """Readable table of `detect_all` findings ('' when clean)."""
    if not findings:
        return ""
    lines = [f"{len(findings)} flagged series "
             f"(robust MAD detector):"]
    for f in findings:
        lines.append(
            f"  {f['row']}.{f['metric']}: {f['kind']} at run "
            f"#{f['index']} — {f['baseline']:g} -> {f['value']:g} "
            f"(score {f['score']:.1f}, hash {f['hash'] or '-'})")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# inline-SVG trend charts
# ---------------------------------------------------------------------------

def _svg_trend(pts: List[dict], flagged: set, width: int = 320,
               height: int = 64) -> str:
    """One series as a self-contained inline SVG: a line through every
    run, points on top, flagged runs highlighted."""
    values = [p["value"] for p in pts]
    lo, hi = min(values), max(values)
    pad = 6.0
    span = (hi - lo) or max(abs(hi), 1.0) * 1e-6

    def x(i: int) -> float:
        return pad + (width - 2 * pad) * (i / max(len(values) - 1, 1))

    def y(v: float) -> float:
        return height - pad - (height - 2 * pad) * ((v - lo) / span)

    path = " ".join(f"{'M' if i == 0 else 'L'}{x(i):.1f},{y(v):.1f}"
                    for i, v in enumerate(values))
    dots = []
    for i, v in enumerate(values):
        flag = i in flagged
        dots.append(
            f'<circle cx="{x(i):.1f}" cy="{y(v):.1f}" '
            f'r="{4 if flag else 2}" '
            f'fill="{"#c0392b" if flag else "#2c5f8a"}">'
            f'<title>run {i}: {v:g}</title></circle>')
    return (
        f'<svg viewBox="0 0 {width} {height}" width="{width}" '
        f'height="{height}" role="img">'
        f'<rect width="{width}" height="{height}" fill="#f7f8fa"/>'
        f'<path d="{path}" fill="none" stroke="#2c5f8a" '
        f'stroke-width="1.5"/>' + "".join(dots) + "</svg>")


# ---------------------------------------------------------------------------
# the HTML observatory
# ---------------------------------------------------------------------------

_CSS = """
body { font: 14px/1.45 -apple-system, 'Segoe UI', Roboto, sans-serif;
       color: #1f2430; margin: 2rem auto; max-width: 70rem;
       padding: 0 1rem; }
h1 { font-size: 1.4rem; } h2 { font-size: 1.1rem; margin-top: 2rem;
       border-bottom: 1px solid #d7dbe2; padding-bottom: .2rem; }
table { border-collapse: collapse; margin: .5rem 0 1rem; width: 100%; }
th, td { text-align: left; padding: .25rem .6rem; font-size: 13px;
       border-bottom: 1px solid #e4e7ec; vertical-align: top; }
th { color: #5a6372; font-weight: 600; }
code { font: 12px ui-monospace, monospace; background: #f0f2f5;
       padding: 0 .25rem; border-radius: 3px; }
.metric { display: inline-block; margin: .4rem 1.2rem .4rem 0;
       vertical-align: top; }
.metric .name { font-size: 12px; color: #5a6372; }
.metric .val { font-size: 13px; }
.flag { color: #c0392b; font-weight: 600; }
.ok { color: #1e7f4f; font-weight: 600; }
.muted { color: #8a93a3; font-size: 12px; }
"""


def _iso(ts: float) -> str:
    if not ts:
        return "-"
    return datetime.datetime.fromtimestamp(
        ts, tz=datetime.timezone.utc).strftime("%Y-%m-%d %H:%M:%SZ")


def build_html(entries: List[dict], results: Optional[dict] = None,
               title: str = "bench observatory",
               threshold: float = DEFAULT_THRESHOLD,
               min_points: int = DEFAULT_MIN_POINTS) -> str:
    """The full self-contained observatory document as a string.

    ``entries`` is the parsed ledger (`launch.history.load_history`);
    ``results`` the committed ``bench_results.json`` object (its
    ``_bench_meta`` block supplies the committed reference line per
    row).  Deterministic: same inputs, same bytes.
    """
    esc = _html.escape
    series = history_series(entries)
    findings = detect_all(entries, threshold, min_points,
                          include_wall=True)
    flagged: Dict[Tuple[str, str], set] = {}
    for f in findings:
        flagged.setdefault((f["row"], f["metric"]), set()).add(f["index"])
    rows = sorted({r for r, _ in series})
    meta = (results or {}).get("_bench_meta", {})
    by_row: Dict[str, List[dict]] = {}
    for e in entries:
        if e.get("row"):
            by_row.setdefault(e["row"], []).append(e)
    last_ts = max((float(e.get("ts") or 0.0) for e in entries),
                  default=0.0)

    out = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>",
        f"<title>{esc(title)}</title><style>{_CSS}</style></head><body>",
        f"<h1>{esc(title)}</h1>",
        f"<p class='muted'>{len(entries)} ledger entries · "
        f"{len(rows)} rows · latest run {_iso(last_ts)} · robust-MAD "
        f"threshold {threshold:g} (min {min_points} points)</p>",
    ]

    if findings:
        out.append(f"<p class='flag'>{len(findings)} flagged "
                   "series</p><table><tr><th>row</th><th>metric</th>"
                   "<th>kind</th><th>baseline</th><th>value</th>"
                   "<th>score</th><th>hash</th></tr>")
        for f in findings:
            out.append(
                f"<tr><td>{esc(f['row'])}</td><td>{esc(f['metric'])}"
                f"</td><td class='flag'>{esc(f['kind'])}</td>"
                f"<td>{f['baseline']:g}</td><td>{f['value']:g}</td>"
                f"<td>{f['score']:.1f}</td>"
                f"<td><code>{esc(f['hash'] or '-')}</code></td></tr>")
        out.append("</table>")
    else:
        out.append("<p class='ok'>no drift flagged</p>")

    for row in rows:
        committed = meta.get(row, {})
        out.append(f"<h2>{esc(row)}</h2>")
        if committed:
            out.append(
                "<p class='muted'>committed: "
                f"<code>{esc(str(committed.get('derived', '')))}</code>"
                f" · wall {float(committed.get('us_per_call', 0.0)):,.0f}"
                " us/call</p>")
        metrics = sorted(m for r, m in series if r == row)
        # wall-time trend first, then the derived metrics
        metrics.sort(key=lambda m: (m != WALL_METRIC, m))
        for m in metrics:
            pts = series[(row, m)]
            fl = flagged.get((row, m), set())
            label = "wall (us/call)" if m == WALL_METRIC else m
            cls = " flag" if fl else ""
            out.append(
                f"<div class='metric'><div class='name{cls}'>"
                f"{esc(label)}</div>"
                + _svg_trend(pts, fl)
                + f"<div class='val'>{pts[0]['value']:g} &rarr; "
                f"{pts[-1]['value']:g} <span class='muted'>"
                f"(n={len(pts)})</span></div></div>")
        out.append("<table><tr><th>run (UTC)</th><th>wall us/call</th>"
                   "<th>derived</th><th>config hash</th></tr>")
        for e in by_row.get(row, []):
            out.append(
                f"<tr><td>{_iso(float(e.get('ts') or 0.0))}</td>"
                f"<td>{float(e.get('us_per_call') or 0.0):,.0f}</td>"
                f"<td><code>{esc(str(e.get('derived', '')))}</code></td>"
                f"<td><code>{esc(str(e.get('hash', '') or '-'))}</code>"
                "</td></tr>")
        out.append("</table>")

    out.append("<p class='muted'>generated by repro_torch.obs.report — "
               "stdlib-only, deterministic for the same ledger</p>")
    out.append("</body></html>")
    return "".join(out)


def write_html(path: str, entries: List[dict],
               results: Optional[dict] = None, **kwargs) -> str:
    """Write `build_html` to ``path``; returns the document."""
    doc = build_html(entries, results, **kwargs)
    with open(path, "w", encoding="utf-8") as f:
        f.write(doc)
    return doc
