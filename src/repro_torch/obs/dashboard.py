"""The ``GET /`` dashboard — one self-contained HTML page, zero deps.

Inline CSS + vanilla JS polling ``/api/top`` (ranked bottlenecks with
window deltas) and ``/api/hosts`` (per-host lanes + capture-health
strip).  No build step, no external assets, works from ``curl`` dumped
to a file — the "point a browser at a running fleet" product shape with
nothing to install on the aggregator.
"""

DASHBOARD_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>GAPP fleet profiler</title>
<style>
  :root { color-scheme: dark; }
  body { background:#14161a; color:#d8dce2; font:14px/1.45 ui-monospace,
         SFMono-Regular,Menlo,Consolas,monospace; margin:1.2rem; }
  h1 { font-size:1.15rem; margin:0 0 .2rem; color:#fff; }
  .sub { color:#8b93a1; margin-bottom:1rem; }
  .strip { display:flex; flex-wrap:wrap; gap:.6rem; margin:.8rem 0; }
  .pill { background:#1e2128; border:1px solid #2c313a; border-radius:6px;
          padding:.25rem .6rem; }
  .pill b { color:#fff; }
  .pill.bad { border-color:#a33; color:#f2a0a0; }
  table { border-collapse:collapse; width:100%; margin:.4rem 0 1.2rem; }
  th, td { text-align:left; padding:.3rem .6rem;
           border-bottom:1px solid #262a32; }
  th { color:#8b93a1; font-weight:normal; }
  td.num, th.num { text-align:right; font-variant-numeric:tabular-nums; }
  .up { color:#ff8f8f; } .down { color:#8fe3a0; } .flat { color:#8b93a1; }
  .lane { display:flex; align-items:center; gap:.6rem; margin:.2rem 0; }
  .lane .name { width:14rem; overflow:hidden; text-overflow:ellipsis;
                white-space:nowrap; }
  .bar { height:.8rem; background:#3a6ea5; border-radius:2px;
         min-width:2px; }
  .lane .val { color:#8b93a1; }
  h2 { font-size:.95rem; color:#aeb6c2; margin:1.2rem 0 .3rem; }
  #err { color:#f2a0a0; }
</style>
</head>
<body>
<h1>GAPP fleet profiler</h1>
<div class="sub">live serialization bottlenecks —
  <a href="/api/report" style="color:#7aa2d6">report</a> ·
  <a href="/api/top" style="color:#7aa2d6">top</a> ·
  <a href="/api/hosts" style="color:#7aa2d6">hosts</a> ·
  <a href="/metrics" style="color:#7aa2d6">metrics</a>
  <span id="err"></span></div>
<div class="strip" id="health"></div>
<h2>top bottlenecks <span id="winlabel" class="flat"></span></h2>
<table><thead><tr><th class="num">#</th><th>path</th>
<th class="num">CMetric (ms)</th><th class="num">&Delta; window</th>
<th class="num">slices</th></tr></thead><tbody id="top"></tbody></table>
<h2>what-if <span class="flat">(counterfactual projection)</span></h2>
<form id="wiform">
  <input id="witarget" size="34"
         placeholder="tag &mdash; or host:NAME, worker:NAME, #rank">
  shrink <input id="wishrink" value="0" size="4">
  <button>project</button>
</form>
<div id="wiout"></div>
<h2>per-host lanes</h2>
<div id="lanes"></div>
<script>
"use strict";
const fmtMs = s => (s * 1e3).toFixed(3);
function esc(s) { const d = document.createElement("span");
  d.textContent = String(s); return d.innerHTML; }
async function poll() {
  try {
    const top = await (await fetch("/api/top?n=15")).json();
    const hosts = await (await fetch("/api/hosts")).json();
    document.getElementById("err").textContent = "";
    render(top, hosts);
  } catch (e) {
    document.getElementById("err").textContent = " — poll failed: " + e;
  }
  setTimeout(poll, 2000);
}
function render(top, hosts) {
  const rows = [];
  for (const e of top.entries || []) {
    let d = '<span class="flat">&ndash;</span>';
    if (e.delta_cmetric_s != null && Math.abs(e.delta_cmetric_s) > 1e-9) {
      const up = e.delta_cmetric_s > 0;
      d = `<span class="${up ? "up" : "down"}">${up ? "&#9650;" : "&#9660;"} ` +
          `${fmtMs(Math.abs(e.delta_cmetric_s))}</span>`;
    }
    rows.push(`<tr><td class="num">${e.rank}</td><td>${esc(e.path)}</td>` +
      `<td class="num">${fmtMs(e.cmetric_s)}</td><td class="num">${d}</td>` +
      `<td class="num">${e.slices}</td></tr>`);
  }
  document.getElementById("top").innerHTML = rows.join("");
  document.getElementById("winlabel").textContent =
    top.window_s ? `(last ${top.window_s}s, vs previous poll)`
                 : "(whole capture, vs previous poll)";
  const lanes = [];
  const ph = hosts.hosts || {};
  const max = Math.max(1e-12,
    ...Object.values(ph).map(h => h.cmetric_s || 0));
  for (const [name, h] of Object.entries(ph)
         .sort((a, b) => (b[1].cmetric_s || 0) - (a[1].cmetric_s || 0))) {
    const w = Math.max(1, Math.round(420 * (h.cmetric_s || 0) / max));
    lanes.push(`<div class="lane"><span class="name">${esc(name)}</span>` +
      `<span class="bar" style="width:${w}px"></span>` +
      `<span class="val">${fmtMs(h.cmetric_s || 0)} ms · ` +
      `${h.workers} worker(s) · ${h.critical} critical</span></div>`);
  }
  document.getElementById("lanes").innerHTML =
    lanes.join("") || '<span class="flat">no host lanes ' +
    '(single-host session)</span>';
  const strip = [];
  const H = hosts.health || {};
  const bad = k => ["shed_chunks", "shed_rows", "ring_dropped",
                    "lost_chunks", "watch_errors"].includes(k) && H[k] > 0;
  strip.push(`<span class="pill">mode <b>${esc(hosts.mode || "?")}</b></span>`);
  strip.push(`<span class="pill">events folded ` +
             `<b>${hosts.events_folded ?? 0}</b></span>`);
  for (const [k, v] of Object.entries(H)) {
    strip.push(`<span class="pill${bad(k) ? " bad" : ""}">` +
               `${esc(k)} <b>${esc(v)}</b></span>`);
  }
  document.getElementById("health").innerHTML = strip.join("");
}
async function whatif(ev) {
  ev.preventDefault();
  const raw = document.getElementById("witarget").value.trim();
  const shrink = document.getElementById("wishrink").value.trim() || "0";
  const out = document.getElementById("wiout");
  if (!raw) { out.innerHTML = ""; return; }
  let q;
  if (raw.startsWith("#")) q = "path=" + encodeURIComponent(raw.slice(1));
  else if (raw.startsWith("host:"))
    q = "host=" + encodeURIComponent(raw.slice(5));
  else if (raw.startsWith("worker:"))
    q = "worker=" + encodeURIComponent(raw.slice(7));
  else q = "tag=" + encodeURIComponent(raw);
  try {
    const r = await fetch(
      `/api/whatif?${q}&shrink=${encodeURIComponent(shrink)}`);
    const d = await r.json();
    if (!r.ok) {
      out.innerHTML =
        `<span class="pill bad">${esc(d.error || r.status)}</span>`;
      return;
    }
    const sp = d.speedup == null ? "&infin;" : d.speedup.toFixed(3) + "x";
    const rows = (d.ranking || []).slice(0, 8).map(e => {
      let mv = '<span class="flat">&ndash;</span>';
      if (e.baseline_rank == null) mv = '<span class="up">new</span>';
      else if (e.rank_delta) {
        const up = e.rank_delta > 0;  // prev - new: positive moved up
        mv = `<span class="${up ? "up" : "down"}">` +
             `${up ? "&#9650;" : "&#9660;"}${Math.abs(e.rank_delta)}</span>`;
      }
      return `<tr><td class="num">${e.rank}</td><td>${esc(e.path)}</td>` +
        `<td class="num">${fmtMs(e.cmetric_s)}</td>` +
        `<td class="num">${mv}</td></tr>`;
    });
    out.innerHTML =
      `<div class="strip">` +
      `<span class="pill">projected speedup <b>${sp}</b></span>` +
      `<span class="pill">saves <b>${fmtMs(d.saved_s)} ms</b></span>` +
      `<span class="pill">matched <b>${d.matched_slices}</b> ` +
      `critical slice(s)</span></div>` +
      `<table><thead><tr><th class="num">#</th>` +
      `<th>counterfactual ranking</th><th class="num">CMetric (ms)</th>` +
      `<th class="num">move</th></tr></thead>` +
      `<tbody>${rows.join("")}</tbody></table>`;
  } catch (e) {
    out.innerHTML = `<span class="pill bad">what-if failed: ${esc(e)}</span>`;
  }
}
document.getElementById("wiform").addEventListener("submit", whatif);
poll();
</script>
</body>
</html>
"""
