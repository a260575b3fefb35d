"""Self-contained interactive HTML report.

Re-imagined equivalent of the reference's handlebars + vega report
(reference: src/html_report.rs:232-325, hbs/*.hbs): zero external or
vendored dependencies — a small embedded JS/SVG renderer draws bar,
multi-bar, line, heatmap and hexbin charts; tables and the raw TSVs are
embedded for download. Works offline from a single file.

The port's copy of panacus_tpu/report/html.py. A report written by either
package differs from the other's only in its <footer> line (time, version,
writer); the <h1> keeps the project's name so that the two diff clean.
"""

from __future__ import annotations

import datetime
import html as html_mod
import json
from typing import Dict, List

from .sections import AnalysisSection

CSS = """
:root { --bg:#ffffff; --fg:#1c1e21; --muted:#6b7280; --accent:#2563eb;
        --card:#f6f7f9; --border:#e5e7eb; }
@media (prefers-color-scheme: dark) {
  :root { --bg:#111418; --fg:#e5e7eb; --muted:#9ca3af; --accent:#60a5fa;
          --card:#1a1f26; --border:#2d333b; }
}
* { box-sizing: border-box; }
body { margin:0; font:14px/1.5 system-ui,-apple-system,"Segoe UI",sans-serif;
       background:var(--bg); color:var(--fg); }
.layout { display:flex; min-height:100vh; }
nav { width:270px; flex:none; border-right:1px solid var(--border);
      padding:1rem; position:sticky; top:0; height:100vh; overflow-y:auto; }
nav h1 { font-size:1.1rem; margin:0 0 1rem; }
nav .run { font-weight:600; margin-top:.8rem; color:var(--muted);
           text-transform:uppercase; font-size:.75rem; letter-spacing:.04em;
           overflow-wrap:anywhere; }
nav a { display:block; padding:.25rem .5rem; color:var(--fg);
        text-decoration:none; border-radius:6px; overflow-wrap:anywhere; }
nav a:hover { background:var(--card); }
main { flex:1; padding:1.5rem 2rem; max-width:1100px; }
section.card { background:var(--card); border:1px solid var(--border);
  border-radius:10px; padding:1rem 1.25rem; margin-bottom:1.5rem; }
section.card h2 { margin:.1rem 0 .2rem; font-size:1.05rem; }
section.card .meta { color:var(--muted); font-size:.8rem; margin-bottom:.6rem; }
svg text { fill:var(--fg); font:11px system-ui,sans-serif; }
svg .axis line, svg .axis path { stroke:var(--muted); }
table.data { border-collapse:collapse; width:100%; }
table.data th, table.data td { border:1px solid var(--border);
  padding:.3rem .6rem; text-align:left; }
.btn { display:inline-block; border:1px solid var(--border); cursor:pointer;
  background:var(--bg); color:var(--fg); border-radius:6px;
  padding:.2rem .6rem; font-size:.78rem; margin:.15rem .3rem .4rem 0; }
.btn:hover { border-color:var(--accent); color:var(--accent); }
footer { color:var(--muted); font-size:.78rem; padding:1rem 2rem;
  border-top:1px solid var(--border); }
"""

# A compact chart renderer: draws into an SVG element from the JSON spec of
# each ReportItem. Linear/log scales, axes, tooltips via <title>.
JS = r"""
function el(n, attrs) {
  const e = document.createElementNS('http://www.w3.org/2000/svg', n);
  for (const k in (attrs || {})) e.setAttribute(k, attrs[k]);
  return e;
}
function niceTicks(lo, hi, n) {
  if (!(hi > lo)) hi = lo + 1;
  const span = hi - lo, step0 = Math.pow(10, Math.floor(Math.log10(span / n)));
  let step = step0;
  for (const m of [1, 2, 5, 10]) { if (span / (step0 * m) <= n) { step = step0 * m; break; } }
  const out = [];
  for (let v = Math.ceil(lo / step) * step; v <= hi + 1e-9; v += step) out.push(v);
  return out;
}
const PALETTE = ['#2563eb','#db2777','#059669','#d97706','#7c3aed',
                 '#0891b2','#dc2626','#4d7c0f','#9333ea','#0284c7'];
function fmtNum(v) {
  if (Math.abs(v) >= 1e6) return (v/1e6).toPrecision(3) + 'M';
  if (Math.abs(v) >= 1e3) return (v/1e3).toPrecision(3) + 'k';
  return (+v.toPrecision(4)).toString();
}
function drawAxes(svg, M, W, H, ymax, ylog, ylabel) {
  const g = el('g', {class: 'axis'});
  const ticks = ylog ? [] : niceTicks(0, ymax, 5);
  if (ylog) { for (let e = 0; Math.pow(10, e) <= ymax; e++) ticks.push(Math.pow(10, e)); }
  for (const t of ticks) {
    const y = ylog ? H - M.b - (Math.log10(Math.max(t,1)) / Math.log10(Math.max(ymax,10))) * (H - M.t - M.b)
                   : H - M.b - (t / ymax) * (H - M.t - M.b);
    const ln = el('line', {x1: M.l, x2: W - M.r, y1: y, y2: y,
                           stroke: 'currentColor', 'stroke-opacity': 0.12});
    g.appendChild(ln);
    const tx = el('text', {x: M.l - 6, y: y + 3, 'text-anchor': 'end'});
    tx.textContent = fmtNum(t);
    g.appendChild(tx);
  }
  if (ylabel) {
    const tx = el('text', {x: 12, y: (H - M.t - M.b) / 2 + M.t,
      transform: `rotate(-90 12 ${(H - M.t - M.b) / 2 + M.t})`, 'text-anchor': 'middle'});
    tx.textContent = ylabel;
    g.appendChild(tx);
  }
  svg.appendChild(g);
}
function renderBar(div, spec, log) {
  div.innerHTML = '';
  const W = 860, H = 340, M = {l: 64, r: 12, t: 12, b: 66};
  const svg = el('svg', {viewBox: `0 0 ${W} ${H}`, width: '100%'});
  const vals = spec.values, n = vals.length;
  const ymax = Math.max(...vals, 1);
  drawAxes(svg, M, W, H, ymax, log, spec.y_label);
  const bw = (W - M.l - M.r) / Math.max(n, 1);
  const base = H - M.b;
  vals.forEach((v, i) => {
    const h = log ? (v > 0 ? Math.log10(v) / Math.log10(Math.max(ymax, 10)) : 0)
                  : v / ymax;
    const r = el('rect', {x: M.l + i * bw + bw * 0.08, y: base - h * (H - M.t - M.b),
      width: bw * 0.84, height: Math.max(h * (H - M.t - M.b), 0), fill: PALETTE[0]});
    const t = el('title'); t.textContent = spec.labels[i] + ': ' + v; r.appendChild(t);
    svg.appendChild(r);
    if (n <= 40 || i % Math.ceil(n / 40) === 0) {
      const tx = el('text', {x: M.l + i * bw + bw / 2, y: base + 12,
        'text-anchor': 'end', transform:
        `rotate(-45 ${M.l + i * bw + bw / 2} ${base + 12})`});
      tx.textContent = spec.labels[i];
      svg.appendChild(tx);
    }
  });
  div.appendChild(svg);
}
function renderMultiBar(div, spec, log) {
  div.innerHTML = '';
  const W = 860, H = 360, M = {l: 64, r: 12, t: 12, b: 66};
  const svg = el('svg', {viewBox: `0 0 ${W} ${H}`, width: '100%'});
  const series = spec.values, n = spec.labels.length, k = series.length;
  const ymax = Math.max(...series.flat().filter(v => isFinite(v)), 1);
  drawAxes(svg, M, W, H, ymax, log, spec.y_label);
  const gw = (W - M.l - M.r) / Math.max(n, 1), bw = gw / (k + 0.5);
  const base = H - M.b;
  series.forEach((row, s) => {
    row.slice(1).forEach((v, i) => {
      if (!isFinite(v)) return;
      const h = log ? (v > 0 ? Math.log10(v) / Math.log10(Math.max(ymax, 10)) : 0) : v / ymax;
      const r = el('rect', {x: M.l + i * gw + s * bw, y: base - h * (H - M.t - M.b),
        width: Math.max(bw * 0.9, 0.5), height: Math.max(h * (H - M.t - M.b), 0),
        fill: PALETTE[s % PALETTE.length]});
      const t = el('title');
      t.textContent = `${spec.names[s]} @ ${spec.labels[i]}: ${v}`;
      r.appendChild(t);
      svg.appendChild(r);
    });
  });
  spec.labels.forEach((lb, i) => {
    if (n <= 40 || i % Math.ceil(n / 40) === 0) {
      const tx = el('text', {x: M.l + i * gw + gw / 2, y: base + 12,
        'text-anchor': 'end',
        transform: `rotate(-45 ${M.l + i * gw + gw / 2} ${base + 12})`});
      tx.textContent = lb;
      svg.appendChild(tx);
    }
  });
  spec.names.forEach((nm, s) => {
    const lx = M.l + 8, ly = M.t + 14 * s + 8;
    svg.appendChild(el('rect', {x: lx, y: ly - 8, width: 10, height: 10,
      fill: PALETTE[s % PALETTE.length]}));
    const tx = el('text', {x: lx + 14, y: ly});
    tx.textContent = nm;
    svg.appendChild(tx);
  });
  div.appendChild(svg);
}
function renderLine(div, spec) {
  div.innerHTML = '';
  const W = 860, H = 340, M = {l: 64, r: 12, t: 12, b: 46};
  const svg = el('svg', {viewBox: `0 0 ${W} ${H}`, width: '100%'});
  const xs = spec.x_values, ys = spec.y_values;
  const xmax = Math.max(...xs, 1), ymax = Math.max(...ys, 1);
  drawAxes(svg, M, W, H, ymax, spec.log_y, spec.y_label);
  const px = x => M.l + (spec.log_x ? Math.log10(Math.max(x, 1)) / Math.log10(Math.max(xmax, 10))
                                    : x / xmax) * (W - M.l - M.r);
  const py = y => H - M.b - (spec.log_y ? (y > 0 ? Math.log10(y) / Math.log10(Math.max(ymax, 10)) : 0)
                                        : y / ymax) * (H - M.t - M.b);
  let d = '';
  xs.forEach((x, i) => { d += (i ? 'L' : 'M') + px(x) + ' ' + py(ys[i]); });
  svg.appendChild(el('path', {d: d, fill: 'none', stroke: PALETTE[0], 'stroke-width': 1.6}));
  const tx = el('text', {x: (W - M.l - M.r) / 2 + M.l, y: H - 8, 'text-anchor': 'middle'});
  tx.textContent = spec.x_label;
  svg.appendChild(tx);
  div.appendChild(svg);
}
function renderHeatmap(div, spec) {
  div.innerHTML = '';
  const n = spec.x_labels.length;
  const cell = Math.max(Math.min(640 / Math.max(n, 1), 40), 7);
  const L = 120, T = 110;
  const W = L + n * cell + 20, H = T + n * cell + 20;
  const svg = el('svg', {viewBox: `0 0 ${W} ${H}`, width: '100%',
                         style: 'max-width:' + W + 'px'});
  let lo = Infinity, hi = -Infinity;
  spec.values.forEach(r => r.forEach(v => { lo = Math.min(lo, v); hi = Math.max(hi, v); }));
  const col = v => {
    const t = (v - lo) / Math.max(hi - lo, 1e-9);
    const h = 250 - 250 * t;
    return `hsl(${h} 75% ${25 + 45 * (1 - Math.abs(t - 0.5))}%)`;
  };
  spec.values.forEach((row, i) => row.forEach((v, j) => {
    const r = el('rect', {x: L + j * cell, y: T + i * cell,
      width: cell - 0.5, height: cell - 0.5, fill: col(v)});
    const t = el('title');
    t.textContent = `${spec.y_labels[i]} × ${spec.x_labels[j]}: ${v.toFixed ? v.toFixed(4) : v}`;
    r.appendChild(t);
    svg.appendChild(r);
  }));
  spec.y_labels.forEach((lb, i) => {
    const tx = el('text', {x: L - 5, y: T + i * cell + cell / 2 + 3, 'text-anchor': 'end'});
    tx.textContent = lb; svg.appendChild(tx);
  });
  spec.x_labels.forEach((lb, j) => {
    const x = L + j * cell + cell / 2;
    const tx = el('text', {x: x, y: T - 6, 'text-anchor': 'start',
                           transform: `rotate(-60 ${x} ${T - 6})`});
    tx.textContent = lb; svg.appendChild(tx);
  });
  div.appendChild(svg);
}
function renderHexbin(div, spec) {
  div.innerHTML = '';
  const W = 860, H = 400, M = {l: 64, r: 16, t: 14, b: 46};
  const svg = el('svg', {viewBox: `0 0 ${W} ${H}`, width: '100%'});
  const bins = spec.bins;
  if (!bins.length) { div.appendChild(svg); return; }
  const xmax = Math.max(...bins.map(b => b.x), 1);
  const ymax = Math.max(...bins.map(b => b.y), 1);
  const smax = Math.max(...bins.map(b => b.size), 1);
  for (const b of bins) {
    const x = M.l + (b.x / xmax) * (W - M.l - M.r);
    const y = H - M.b - (b.y / ymax) * (H - M.t - M.b);
    const t = Math.log(1 + b.size) / Math.log(1 + smax);
    const r = 4 + 10 * t;
    const hex = [];
    for (let a = 0; a < 6; a++) {
      hex.push((x + r * Math.cos(Math.PI / 3 * a + Math.PI / 6)) + ',' +
               (y + r * Math.sin(Math.PI / 3 * a + Math.PI / 6)));
    }
    const p = el('polygon', {points: hex.join(' '),
      fill: `hsl(${250 - 250 * t} 75% 50%)`, 'fill-opacity': 0.85});
    const ti = el('title');
    ti.textContent = `coverage ${b.x.toFixed(2)}, log-len ${b.y.toFixed(2)}: ${b.size} nodes`;
    p.appendChild(ti);
    svg.appendChild(p);
  }
  const tx = el('text', {x: (W - M.l - M.r) / 2 + M.l, y: H - 8, 'text-anchor': 'middle'});
  tx.textContent = 'coverage';
  svg.appendChild(tx);
  const ty = el('text', {x: 12, y: H / 2, transform: `rotate(-90 12 ${H / 2})`,
                         'text-anchor': 'middle'});
  ty.textContent = 'log10(node length)';
  svg.appendChild(ty);
  div.appendChild(svg);
}
function downloadText(name, text) {
  const a = document.createElement('a');
  a.href = URL.createObjectURL(new Blob([text], {type: 'text/tab-separated-values'}));
  a.download = name;
  a.click();
}
function downloadSvg(id) {
  const svg = document.querySelector('#' + CSS.escape(id) + ' svg');
  if (!svg) return;
  const a = document.createElement('a');
  a.href = URL.createObjectURL(new Blob([new XMLSerializer().serializeToString(svg)],
                                        {type: 'image/svg+xml'}));
  a.download = id + '.svg';
  a.click();
}
window.addEventListener('DOMContentLoaded', () => {
  for (const d of document.querySelectorAll('[data-spec]')) {
    const spec = JSON.parse(d.dataset.spec);
    const kind = d.dataset.kind;
    const log = d.dataset.log === '1';
    if (kind === 'Bar') renderBar(d, spec, false);
    else if (kind === 'MultiBar') renderMultiBar(d, spec, false);
    else if (kind === 'Line') renderLine(d, spec);
    else if (kind === 'Heatmap') renderHeatmap(d, spec);
    else if (kind === 'Hexbin') renderHexbin(d, spec);
    if (log) {
      const btn = document.createElement('button');
      btn.className = 'btn';
      btn.textContent = 'toggle log scale';
      let state = false;
      btn.onclick = () => {
        state = !state;
        if (kind === 'Bar') renderBar(d, spec, state);
        else if (kind === 'MultiBar') renderMultiBar(d, spec, state);
        d.appendChild(btn);
      };
      d.appendChild(btn);
    }
  }
});
"""


def _esc(s: str) -> str:
    return html_mod.escape(str(s), quote=True)


def _render_item(item: Dict) -> str:
    (kind, spec), = item.items()
    iid = spec.get("id", "item")
    if kind == "Table":
        head = "".join(f"<th>{_esc(h)}</th>" for h in spec["header"])
        rows = "".join(
            "<tr>" + "".join(f"<td>{_esc(c)}</td>" for c in row) + "</tr>"
            for row in spec["values"]
        )
        return (
            f'<table class="data" id="{_esc(iid)}">'
            f"<thead><tr>{head}</tr></thead><tbody>{rows}</tbody></table>"
        )
    if kind == "Png":
        return (
            f'<img id="{_esc(iid)}" style="max-width:100%" '
            f'src="data:image/png;base64,{spec["file"]}">'
        )
    if kind == "Svg":
        return f'<div id="{_esc(iid)}">{spec["file"]}</div>'
    if kind == "Pdf":
        return (
            f'<embed id="{_esc(iid)}" style="width:100%;height:70vh" '
            f'src="data:application/pdf;base64,{spec["file"]}">'
        )
    if kind == "Json":
        return f'<pre id="{_esc(iid)}">{_esc(spec["file"])}</pre>'
    log_flag = "1" if spec.get("log_toggle") else "0"
    payload = _esc(json.dumps(spec))
    return (
        f'<div id="{_esc(iid)}" data-kind="{kind}" data-log="{log_flag}" '
        f"data-spec=\"{payload}\"></div>"
    )


def generate_report(sections: List[AnalysisSection], fname: str) -> str:
    from .. import version_string

    nav: List[str] = []
    body: List[str] = []
    runs_seen: Dict[str, bool] = {}
    for s in sections:
        if s.run_name not in runs_seen:
            runs_seen[s.run_name] = True
            nav.append(f'<div class="run">{_esc(s.run_name) or "run"}</div>')
        nav.append(
            f'<a href="#{_esc(s.id)}">{_esc(s.analysis)} · {_esc(s.countable)}</a>'
        )
        items_html = "".join(_render_item(i) for i in s.items)
        dl = ""
        if s.table:
            tsv = s.table
            if tsv.startswith("`") and tsv.endswith("`"):
                tsv = tsv[1:-1]
            dl = (
                f"<button class='btn' onclick='downloadText(\"{_esc(s.id)}.tsv\","
                f" this.dataset.t)' data-t=\"{_esc(tsv)}\">download table</button>"
                f"<button class='btn' onclick='downloadSvg(\"{_esc(s.id)}\")'>"
                "download svg</button>"
            )
        body.append(
            f'<section class="card" id="{_esc(s.id)}">'
            f"<h2>{_esc(s.analysis)}</h2>"
            f'<div class="meta">{_esc(s.run_name)} · {_esc(s.countable)}</div>'
            f"{dl}{items_html}</section>"
        )
    now = datetime.datetime.now().strftime("%Y-%m-%d %H:%M")
    return f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width,initial-scale=1">
<title>panacus report · {_esc(fname)}</title>
<style>{CSS}</style></head>
<body><div class="layout">
<nav><h1>panacus-tpu</h1>{''.join(nav)}</nav>
<main>{''.join(body)}</main>
</div>
<footer>generated by panacus_torch v{version_string()} · {now} · {_esc(fname)}</footer>
<script>{JS}</script>
</body></html>"""
