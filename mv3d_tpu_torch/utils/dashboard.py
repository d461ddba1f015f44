"""Static-HTML training dashboard from :class:`MetricsWriter` JSONL logs.

Port of ``mv3d_tpu/utils/dashboard.py`` (standard library only):
``render_dashboard(log_dir)`` turns every ``metrics_*.jsonl`` of a log
dir into one self-contained HTML file: per-metric line charts (training
and validation series), a hover crosshair and tooltip, a table of last
values and links to debug images; no server, no dependencies.
"""

from __future__ import annotations

import glob
import html
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

# fixed series assignment (color follows the entity, never rank):
# training = slot 1 (blue), validation = slot 2 (orange); both modes
# validated as a categorical pair (dataviz reference palette).
_PHASES = ("training", "validation")

_CSS = """
.viz-root { color-scheme: light;
  --surface-1: #fcfcfb; --grid: #e4e3df;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --series-training: #2a78d6; --series-validation: #eb6834; }
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root { color-scheme: dark;
    --surface-1: #1a1a19; --grid: #32312f;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --series-training: #3987e5; --series-validation: #d95926; } }
body { margin: 0; background: var(--surface-1); }
.viz-root { font: 13px/1.45 system-ui, sans-serif; background: var(--surface-1);
  color: var(--text-primary); padding: 20px; }
.viz-root h1 { font-size: 17px; margin: 0 0 2px; }
.viz-root .sub { color: var(--text-secondary); margin-bottom: 16px; }
.grid { display: flex; flex-wrap: wrap; gap: 20px; }
.card { width: 420px; }
.card h2 { font-size: 13px; font-weight: 600; margin: 0 0 2px; }
.legend { color: var(--text-secondary); font-size: 12px; margin-bottom: 2px; }
.legend .sw { display: inline-block; width: 10px; height: 10px;
  border-radius: 2px; vertical-align: -1px; margin: 0 4px 0 10px; }
svg text { fill: var(--text-secondary); font-size: 10px; }
svg .axis { stroke: var(--grid); stroke-width: 1; }
svg .line { fill: none; stroke-width: 2; }
svg .xhair { stroke: var(--text-secondary); stroke-width: 1;
  stroke-dasharray: 3 3; visibility: hidden; }
.tip { position: fixed; pointer-events: none; visibility: hidden;
  background: var(--surface-1); color: var(--text-primary);
  border: 1px solid var(--grid); border-radius: 4px; padding: 4px 8px;
  font-size: 12px; box-shadow: 0 2px 6px rgba(0,0,0,.15); z-index: 9; }
details { margin-top: 4px; color: var(--text-secondary); }
table { border-collapse: collapse; font-size: 12px; margin-top: 4px; }
td, th { border: 1px solid var(--grid); padding: 2px 8px; text-align: right; }
"""

_JS = """
document.querySelectorAll('svg[data-chart]').forEach(function (svg) {
  var data = JSON.parse(svg.dataset.chart);
  var xh = svg.querySelector('.xhair');
  var tip = document.getElementById('tip');
  svg.addEventListener('mousemove', function (ev) {
    var r = svg.getBoundingClientRect();
    var x = (ev.clientX - r.left) * (Number(svg.dataset.w) / r.width);
    if (x < data.x0 || x > data.x1) { return; }
    var f = (x - data.x0) / (data.x1 - data.x0);
    var lines = [];
    data.series.forEach(function (s) {
      var i = Math.round(f * (s.steps.length - 1));
      if (i >= 0 && i < s.steps.length) {
        lines.push(s.name + ' @' + s.steps[i] + ': ' +
                   Number(s.vals[i]).toPrecision(5));
      }
    });
    xh.setAttribute('x1', x); xh.setAttribute('x2', x);
    xh.style.visibility = 'visible';
    tip.style.visibility = 'visible';
    tip.style.left = (ev.clientX + 14) + 'px';
    tip.style.top = (ev.clientY + 10) + 'px';
    tip.textContent = lines.join('  |  ');
  });
  svg.addEventListener('mouseleave', function () {
    xh.style.visibility = 'hidden';
    document.getElementById('tip').style.visibility = 'hidden';
  });
});
"""


def _downsample(steps: List[int], vals: List[float], cap: int = 600):
    if len(steps) <= cap:
        return steps, vals
    idx = [round(i * (len(steps) - 1) / (cap - 1)) for i in range(cap)]
    return [steps[i] for i in idx], [vals[i] for i in idx]


def load_metrics(log_dir: str) -> Dict[str, Dict[str, Dict[str, list]]]:
    """{tag: {metric: {phase: ([steps], [values])}}} from metrics_*.jsonl."""
    out: Dict[str, Dict[str, Dict[str, list]]] = {}
    for path in sorted(glob.glob(os.path.join(log_dir, "metrics_*.jsonl"))):
        tag = os.path.basename(path)[len("metrics_"):-len(".jsonl")]
        series = out.setdefault(tag, defaultdict(dict))
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail write of a live run
                step = rec.get("step")
                if step is None:    # a stepless record would poison _chart's
                    continue        # min()/arithmetic over the steps list
                phase = rec.get("phase", "training")
                for k, v in rec.items():
                    if k in ("step", "time", "phase") or not isinstance(
                            v, (int, float)):
                        continue
                    s = series[k].setdefault(phase, ([], []))
                    s[0].append(step)
                    s[1].append(float(v))
    return out


def _chart(metric: str, phases: Dict[str, tuple], w=420, h=170) -> str:
    pad_l, pad_r, pad_t, pad_b = 46, 10, 8, 20
    x0, x1 = pad_l, w - pad_r
    y0, y1 = h - pad_b, pad_t
    all_steps = [s for p in phases.values() for s in p[0]]
    all_vals = [v for p in phases.values() for v in p[1]
                if v == v and abs(v) != float("inf")]
    if not all_steps or not all_vals:
        return ""
    smin, smax = min(all_steps), max(all_steps)
    vmin, vmax = min(all_vals), max(all_vals)
    if smax == smin:
        smax += 1
    if vmax == vmin:
        vmax += 1e-9

    def sx(s):
        return x0 + (s - smin) / (smax - smin) * (x1 - x0)

    def sy(v):
        v = min(max(v, vmin), vmax)
        return y0 + (v - vmin) / (vmax - vmin) * (y1 - y0)

    parts = [f'<line class="axis" x1="{x0}" y1="{y0}" x2="{x1}" y2="{y0}"/>']
    series_js = []
    for i in range(5):  # recessive horizontal grid + value labels
        v = vmin + (vmax - vmin) * i / 4
        y = sy(v)
        if i:
            parts.append(f'<line class="axis" x1="{x0}" y1="{y:.1f}" '
                         f'x2="{x1}" y2="{y:.1f}" opacity="0.6"/>')
        parts.append(f'<text x="{x0 - 4}" y="{y + 3:.1f}" '
                     f'text-anchor="end">{v:.3g}</text>')
    for frac in (0, 0.5, 1):
        s = smin + (smax - smin) * frac
        parts.append(f'<text x="{sx(s):.1f}" y="{h - 6}" '
                     f'text-anchor="middle">{int(s)}</text>')
    for phase in _PHASES:
        if phase not in phases:
            continue
        steps, vals = _downsample(*phases[phase])
        pts = " ".join(f"{sx(s):.1f},{sy(v):.1f}"
                       for s, v in zip(steps, vals)
                       if v == v and abs(v) != float("inf"))
        parts.append(f'<polyline class="line" points="{pts}" '
                     f'stroke="var(--series-{phase})"/>')
        series_js.append({"name": phase, "steps": steps, "vals": vals})
    parts.append(f'<line class="xhair" x1="0" x2="0" y1="{y1}" y2="{y0}"/>')
    data = html.escape(json.dumps(
        {"x0": x0, "x1": x1, "series": series_js}), quote=True)
    return (f'<svg data-chart="{data}" data-w="{w}" width="{w}" height="{h}" '
            f'viewBox="0 0 {w} {h}">' + "".join(parts) + "</svg>")


def render_dashboard(log_dir: str, out_html: Optional[str] = None) -> str:
    """Write <log_dir>/dashboard.html from every metrics JSONL; returns the
    path. Debug-image dumps under <log_dir>/debug_images are linked."""
    metrics = load_metrics(log_dir)
    out_html = out_html or os.path.join(log_dir, "dashboard.html")
    body = []
    for tag, per_metric in metrics.items():
        body.append(f"<h1>{html.escape(tag)}</h1>")
        n = max((len(p[0]) for m in per_metric.values()
                 for p in m.values()), default=0)
        body.append(f'<div class="sub">{len(per_metric)} metrics &middot; '
                    f'{n} records &middot; generated '
                    f'{time.strftime("%Y-%m-%d %H:%M:%S")}</div>')
        body.append('<div class="grid">')
        for metric in sorted(per_metric):
            phases = per_metric[metric]
            svg = _chart(metric, phases)
            if not svg:
                continue
            legend = ""
            if len(phases) > 1:
                legend = '<div class="legend">' + "".join(
                    f'<span class="sw" style="background:'
                    f'var(--series-{p})"></span>{p}'
                    for p in _PHASES if p in phases) + "</div>"
            rows = "".join(
                f"<tr><td>{p}</td><td>{phases[p][0][-1]}</td>"
                f"<td>{phases[p][1][-1]:.6g}</td></tr>"
                for p in _PHASES if p in phases)
            body.append(
                f'<div class="card"><h2>{html.escape(metric)}</h2>{legend}'
                f"{svg}<details><summary>last values</summary>"
                f"<table><tr><th>phase</th><th>step</th><th>value</th></tr>"
                f"{rows}</table></details></div>")
        body.append("</div>")
    dbg = os.path.join(log_dir, "debug_images")
    if os.path.isdir(dbg):
        links = "".join(f'<a href="debug_images/{html.escape(d)}/top.png">'
                        f"{html.escape(d)}</a> "
                        for d in sorted(os.listdir(dbg))[-20:])
        body.append(f'<div class="sub">debug images: {links}</div>')
    doc = ("<!doctype html><meta charset=utf-8>"
           "<title>mv3d training dashboard</title>"
           f"<style>{_CSS}</style><body><div class=viz-root>"
           + "".join(body) +
           f'<div class="tip" id="tip"></div></div>'
           f"<script>{_JS}</script>")
    with open(out_html, "w") as f:
        f.write(doc)
    return out_html
