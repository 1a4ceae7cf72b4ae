"""Self-contained HTML / markdown dashboard rendered from a serving
timeline (``TimelineAggregator.timeline()`` + ``summary()``).

The HTML report is a single file with zero external assets: stat tiles for
the headline numbers, then one inline-SVG line chart per panel (TTFT, TBT,
throughput, queue depth, utilization, preemption/COW rates, SLO
attainment) with hover crosshair + tooltip, a legend for multi-series
panels, light/dark theming off ``prefers-color-scheme``, and a <details>
data table per chart as the accessible fallback. Colors are the validated
reference categorical palette (slots 1–3 only per panel) with chart chrome
in the documented ink roles; series identity is never carried by color
alone (legend + table view).
"""
from __future__ import annotations

import html
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Validated reference palette (dataviz reference instance): first three
# categorical slots (all-pairs safe in both modes), light / dark steps.
_SERIES_LIGHT = ["#2a78d6", "#eb6834", "#1baf7a"]
_SERIES_DARK = ["#3987e5", "#d95926", "#199e70"]

_CSS = """
:root { color-scheme: light dark; }
body.viz-root {
  color-scheme: light;
  --surface-1: #fcfcfb; --page: #f9f9f7;
  --text-primary: #0b0b0b; --text-secondary: #52514e; --muted: #898781;
  --grid: #e1e0d9; --axis: #c3c2b7; --border: rgba(11,11,11,0.10);
  --series-1: #2a78d6; --series-2: #eb6834; --series-3: #1baf7a;
  --good: #0ca30c; --critical: #d03b3b;
  margin: 0; background: var(--page); color: var(--text-primary);
  font: 14px/1.45 system-ui, -apple-system, "Segoe UI", sans-serif;
}
@media (prefers-color-scheme: dark) {
  body.viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19; --page: #0d0d0d;
    --text-primary: #ffffff; --text-secondary: #c3c2b7; --muted: #898781;
    --grid: #2c2c2a; --axis: #383835; --border: rgba(255,255,255,0.10);
    --series-1: #3987e5; --series-2: #d95926; --series-3: #199e70;
  }
}
.wrap { max-width: 1180px; margin: 0 auto; padding: 24px 20px 48px; }
h1 { font-size: 20px; font-weight: 650; margin: 0 0 4px; }
.sub { color: var(--text-secondary); margin: 0 0 20px; font-size: 13px; }
.tiles { display: grid; grid-template-columns: repeat(auto-fill, minmax(160px, 1fr));
         gap: 12px; margin-bottom: 20px; }
.tile { background: var(--surface-1); border: 1px solid var(--border);
        border-radius: 10px; padding: 12px 14px; }
.tile .k { color: var(--text-secondary); font-size: 12px; }
.tile .v { font-size: 22px; font-weight: 650; margin-top: 2px; }
.tile .u { color: var(--muted); font-size: 12px; font-weight: 400; }
.grid2 { display: grid; grid-template-columns: repeat(auto-fit, minmax(420px, 1fr));
         gap: 16px; }
.panel { background: var(--surface-1); border: 1px solid var(--border);
         border-radius: 10px; padding: 14px 14px 8px; }
.panel h2 { font-size: 13px; font-weight: 650; margin: 0 0 2px; }
.panel .desc { color: var(--text-secondary); font-size: 12px; margin: 0 0 8px; }
.legend { display: flex; gap: 14px; font-size: 12px; color: var(--text-secondary);
          margin: 0 0 4px; flex-wrap: wrap; }
.legend .chip { display: inline-block; width: 10px; height: 10px;
                border-radius: 3px; margin-right: 5px; vertical-align: -1px; }
svg.chart { width: 100%; height: auto; display: block; }
svg.chart text { fill: var(--muted); font: 11px system-ui, sans-serif; }
.gridline { stroke: var(--grid); stroke-width: 1; }
.axisline { stroke: var(--axis); stroke-width: 1; }
.tooltip { position: fixed; pointer-events: none; background: var(--surface-1);
           border: 1px solid var(--border); border-radius: 8px;
           padding: 6px 10px; font-size: 12px; display: none; z-index: 10;
           box-shadow: 0 2px 10px rgba(0,0,0,0.15); }
.tooltip b { font-weight: 650; }
details { margin: 6px 0 8px; }
summary { color: var(--muted); font-size: 12px; cursor: pointer; }
table.data { border-collapse: collapse; font-size: 12px; margin-top: 6px;
             font-variant-numeric: tabular-nums; }
table.data th, table.data td { border: 1px solid var(--grid);
             padding: 3px 8px; text-align: right; color: var(--text-secondary); }
table.data th { color: var(--text-primary); font-weight: 600; }
"""

_JS = """
(function () {
  var tip = document.createElement('div');
  tip.className = 'tooltip';
  document.body.appendChild(tip);
  document.querySelectorAll('svg.chart').forEach(function (svg) {
    var data = JSON.parse(svg.getAttribute('data-points'));
    var x0 = +svg.getAttribute('data-x0'), x1 = +svg.getAttribute('data-x1');
    var cross = svg.querySelector('.crosshair');
    svg.addEventListener('mousemove', function (ev) {
      var r = svg.getBoundingClientRect();
      var fx = (ev.clientX - r.left) / r.width;
      var vw = svg.viewBox.baseVal;
      var px = fx * vw.width;
      if (px < x0 || px > x1 || !data.t.length) { return; }
      var frac = (px - x0) / (x1 - x0);
      var i = Math.round(frac * (data.t.length - 1));
      i = Math.max(0, Math.min(data.t.length - 1, i));
      var cx = x0 + (data.t.length > 1 ? i / (data.t.length - 1) : 0.5) * (x1 - x0);
      cross.setAttribute('x1', cx); cross.setAttribute('x2', cx);
      cross.style.display = 'block';
      var rows = '<b>t = ' + data.t[i].toFixed(1) + ' s</b>';
      data.series.forEach(function (s) {
        rows += '<br><span class="chip" style="background:' + s.color +
                '"></span>' + s.name + ': ' + s.fmt_values[i];
      });
      tip.innerHTML = rows;
      tip.style.display = 'block';
      tip.style.left = (ev.clientX + 14) + 'px';
      tip.style.top = (ev.clientY + 14) + 'px';
    });
    svg.addEventListener('mouseleave', function () {
      tip.style.display = 'none';
      cross.style.display = 'none';
    });
  });
})();
"""


def _fmt(v: Optional[float], unit: str = "") -> str:
    if v is None:
        return "–"
    if unit == "%":
        return f"{100.0 * v:.1f}%"
    if unit == "ms":
        return f"{1e3 * v:.1f} ms"
    if abs(v) >= 1000:
        return f"{v:,.0f}"
    if abs(v) >= 10:
        return f"{v:.1f}"
    return f"{v:.3g}"


def _polyline(xs: List[float], ys: List[float]) -> str:
    return " ".join(f"{x:.1f},{y:.1f}" for x, y in zip(xs, ys))


def _chart(title: str, desc: str, t: List[float],
           series: Sequence[Tuple[str, int, List[Optional[float]], str]],
           *, y_max: Optional[float] = None) -> str:
    """One panel: ``series`` is (name, palette_slot_1based, values, unit).
    Gaps (None) break the polyline."""
    W, H = 560, 180
    PL, PR, PT, PB = 46, 10, 8, 22
    x0, x1 = PL, W - PR
    vals = [v for _, _, vs, _ in series for v in vs if v is not None]
    vmax = y_max if y_max is not None else (max(vals) if vals else 1.0)
    vmax = vmax if vmax > 0 else 1.0
    vmax *= 1.05
    t_span = (t[-1] - t[0]) if len(t) > 1 else 1.0

    def sx(i: int) -> float:
        if len(t) <= 1:
            return (x0 + x1) / 2
        return x0 + (t[i] - t[0]) / t_span * (x1 - x0)

    def sy(v: float) -> float:
        return PT + (1.0 - min(v, vmax) / vmax) * (H - PT - PB)

    parts = []
    for k in range(4):                         # recessive horizontal grid
        gy = PT + k / 3 * (H - PT - PB)
        gv = vmax * (1 - k / 3)
        parts.append(f'<line class="gridline" x1="{x0}" y1="{gy:.1f}" '
                     f'x2="{x1}" y2="{gy:.1f}"/>')
        parts.append(f'<text x="{x0 - 6}" y="{gy + 3.5:.1f}" '
                     f'text-anchor="end">{_fmt(gv)}</text>')
    parts.append(f'<line class="axisline" x1="{x0}" y1="{H - PB}" '
                 f'x2="{x1}" y2="{H - PB}"/>')
    parts.append(f'<text x="{x0}" y="{H - 6}">{t[0]:.0f}s</text>')
    parts.append(f'<text x="{x1}" y="{H - 6}" text-anchor="end">{t[-1]:.0f}s</text>')
    for name, slot, vs, unit in series:
        run_x: List[float] = []
        run_y: List[float] = []
        runs = []
        for i, v in enumerate(vs):
            if v is None:
                if run_x:
                    runs.append((run_x, run_y))
                    run_x, run_y = [], []
                continue
            run_x.append(sx(i))
            run_y.append(sy(v))
        if run_x:
            runs.append((run_x, run_y))
        for rx, ry in runs:
            if len(rx) == 1:
                parts.append(f'<circle cx="{rx[0]:.1f}" cy="{ry[0]:.1f}" r="2.5" '
                             f'fill="var(--series-{slot})"/>')
            else:
                parts.append(f'<polyline points="{_polyline(rx, ry)}" fill="none" '
                             f'stroke="var(--series-{slot})" stroke-width="2" '
                             f'stroke-linejoin="round" stroke-linecap="round"/>')
    parts.append(f'<line class="crosshair" x1="0" y1="{PT}" x2="0" y2="{H - PB}" '
                 f'stroke="var(--muted)" stroke-width="1" stroke-dasharray="3 3" '
                 f'style="display:none"/>')

    colors = {1: _SERIES_LIGHT[0], 2: _SERIES_LIGHT[1], 3: _SERIES_LIGHT[2]}
    payload = {
        "t": [round(x, 3) for x in t],
        "series": [{
            "name": name, "color": colors[slot],
            "fmt_values": [_fmt(v, unit) for v in vs],
        } for name, slot, vs, unit in series],
    }
    legend = ""
    if len(series) > 1:
        legend = '<div class="legend">' + "".join(
            f'<span><span class="chip" style="background:var(--series-{slot})">'
            f'</span>{html.escape(name)}</span>'
            for name, slot, _, _ in series) + "</div>"
    head = ["t_s"] + [name for name, _, _, _ in series]
    rows = "".join(
        "<tr><td>" + f"{t[i]:.1f}</td>" + "".join(
            f"<td>{_fmt(vs[i], unit)}</td>" for _, _, vs, unit in series)
        + "</tr>"
        for i in range(len(t)))
    table = (f'<details><summary>data table</summary><table class="data">'
             f'<tr>{"".join(f"<th>{html.escape(h)}</th>" for h in head)}</tr>'
             f"{rows}</table></details>")
    return (
        f'<div class="panel"><h2>{html.escape(title)}</h2>'
        f'<p class="desc">{html.escape(desc)}</p>{legend}'
        f'<svg class="chart" viewBox="0 0 {W} {H}" data-x0="{x0}" data-x1="{x1}" '
        f"data-points='{json.dumps(payload)}'>{''.join(parts)}</svg>"
        f"{table}</div>")


def _tile(label: str, value: str, unit: str = "") -> str:
    u = f' <span class="u">{html.escape(unit)}</span>' if unit else ""
    return (f'<div class="tile"><div class="k">{html.escape(label)}</div>'
            f'<div class="v">{html.escape(value)}{u}</div></div>')


def _col(timeline: List[Dict[str, Any]], key: str) -> List[Optional[float]]:
    return [w.get(key) for w in timeline]


def render_dashboard(timeline: List[Dict[str, Any]], summary: Dict[str, Any],
                     title: str = "Serving timeline") -> str:
    """Render the full HTML dashboard (a single self-contained page)."""
    t = [float(w["t"]) for w in timeline]
    slo = summary.get("slo", {})
    slo_txt = (f"TTFT ≤ {_fmt(slo.get('ttft_target_s'), 'ms')}, "
               f"TBT ≤ {_fmt(slo.get('tbt_target_s'), 'ms')}")
    tiles = "".join([
        _tile("Requests", _fmt(summary.get("n_requests"))),
        _tile("Throughput", _fmt(summary.get("throughput_tok_s")), "tok/s"),
        _tile("p50 TTFT", _fmt(summary.get("p50_ttft_s"), "ms")),
        _tile("p99 TTFT", _fmt(summary.get("p99_ttft_s"), "ms")),
        _tile("p50 TBT", _fmt(summary.get("p50_tbt_s"), "ms")),
        _tile("p99 TBT", _fmt(summary.get("p99_tbt_s"), "ms")),
        _tile("SLO attainment", _fmt(summary.get("slo_attainment"), "%")),
        _tile("Preemptions", _fmt(summary.get("preemptions"))),
        _tile("Shed", _fmt(summary.get("shed", 0))),
        _tile("Failovers", _fmt(summary.get("failovers", 0))),
    ])
    charts = "".join([
        _chart("TTFT", "time to first token per completion window", t, [
            ("p50", 1, _col(timeline, "p50_ttft_s"), "ms"),
            ("p99", 2, _col(timeline, "p99_ttft_s"), "ms")]),
        _chart("TBT", "time between tokens (seconds/token)", t, [
            ("p50", 1, _col(timeline, "p50_tbt_s"), "ms"),
            ("p99", 2, _col(timeline, "p99_tbt_s"), "ms")]),
        _chart("Throughput", "tokens fed per second (prefill + decode + drafts)",
               t, [
            ("total", 1, _col(timeline, "throughput_tok_s"), ""),
            ("decode", 3, _col(timeline, "decode_tok_s"), "")]),
        _chart("Queue", "requests waiting for a slot", t, [
            ("mean depth", 1, _col(timeline, "queue_depth_mean"), ""),
            ("max depth", 2,
             [float(v) if v is not None else None
              for v in _col(timeline, "queue_depth_max")], "")]),
        _chart("Queue wait", "router arrival to engine admission", t, [
            ("p50", 1, _col(timeline, "p50_queue_wait_s"), "ms"),
            ("p99", 2, _col(timeline, "p99_queue_wait_s"), "ms")]),
        _chart("Utilization", "batch occupancy / token-budget fill / KV pages",
               t, [
            ("slots", 1, _col(timeline, "occupancy_frac"), "%"),
            ("budget", 2, _col(timeline, "budget_util"), "%"),
            ("kv", 3, _col(timeline, "kv_util_mean"), "%")], y_max=1.0),
        _chart("Disruption", "preemptions and COW page copies per second", t, [
            ("preempt/s", 1, _col(timeline, "preemptions_per_s"), ""),
            ("cow pages/s", 2, _col(timeline, "cow_pages_per_s"), "")]),
        _chart("SLO attainment", f"fraction of completions meeting {slo_txt}",
               t, [("attained", 1, _col(timeline, "slo_attainment"), "%")],
               y_max=1.0),
        _chart("Resilience", "load shedding, submit retries, deadline"
               " cancellations, and replica failovers per window", t, [
            ("shed", 1,
             [float(v) if v is not None else None
              for v in _col(timeline, "shed")], ""),
            ("retries", 2,
             [float(v) if v is not None else None
              for v in _col(timeline, "retries")], ""),
            ("failovers", 3,
             [float(v) if v is not None else None
              for v in _col(timeline, "failovers")], "")]),
    ])
    return f"""<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{html.escape(title)}</title><style>{_CSS}</style></head>
<body class="viz-root"><div class="wrap">
<h1>{html.escape(title)}</h1>
<p class="sub">{summary.get('n_windows', 0)} windows of
{_fmt(summary.get('window_s'))} s · {summary.get('n_steps', 0)} engine
iterations · SLO: {html.escape(slo_txt)}</p>
<div class="tiles">{tiles}</div>
<div class="grid2">{charts}</div>
</div><script>{_JS}</script></body></html>
"""


def render_markdown(timeline: List[Dict[str, Any]], summary: Dict[str, Any],
                    title: str = "Serving timeline") -> str:
    """Compact markdown twin of the HTML dashboard (for logs / PR bodies)."""
    lines = [f"# {title}", ""]
    lines.append(f"- requests: {summary.get('n_requests')}  "
                 f"(over {summary.get('n_windows')} x "
                 f"{summary.get('window_s')}s windows, "
                 f"{summary.get('n_steps')} engine iterations)")
    lines.append(f"- throughput: {_fmt(summary.get('throughput_tok_s'))} tok/s")
    lines.append(f"- TTFT p50/p99: {_fmt(summary.get('p50_ttft_s'), 'ms')} / "
                 f"{_fmt(summary.get('p99_ttft_s'), 'ms')}")
    lines.append(f"- TBT p50/p99: {_fmt(summary.get('p50_tbt_s'), 'ms')} / "
                 f"{_fmt(summary.get('p99_tbt_s'), 'ms')}")
    lines.append(f"- SLO attainment: {_fmt(summary.get('slo_attainment'), '%')} "
                 f"(targets: TTFT {_fmt(summary.get('slo', {}).get('ttft_target_s'), 'ms')}, "
                 f"TBT {_fmt(summary.get('slo', {}).get('tbt_target_s'), 'ms')})")
    lines.append(f"- preemptions: {summary.get('preemptions')}")
    lines += ["", "| t(s) | done | tok/s | p50 TTFT | p99 TTFT | queue | "
                  "occ | kv | SLO |",
              "|---:|---:|---:|---:|---:|---:|---:|---:|---:|"]
    for w in timeline:
        lines.append(
            f"| {w['t']:.1f} | {w['completed']} "
            f"| {_fmt(w['throughput_tok_s'])} "
            f"| {_fmt(w['p50_ttft_s'], 'ms')} | {_fmt(w['p99_ttft_s'], 'ms')} "
            f"| {_fmt(w['queue_depth_mean'])} | {_fmt(w['occupancy_frac'], '%')} "
            f"| {_fmt(w['kv_util_mean'], '%')} "
            f"| {_fmt(w['slo_attainment'], '%')} |")
    return "\n".join(lines) + "\n"
