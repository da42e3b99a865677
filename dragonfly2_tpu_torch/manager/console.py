"""Embedded web console — the manager's browser UI.

Port of dragonfly2_tpu/manager/console.py, whole.

Capability parity with the reference's embedded console SPA
(manager/manager.go:61-63 embeds `dist/` and serves it at `/`): a single
self-contained page (no build step, no external assets) served by
ManagerREST at `/` that signs in against `/api/v1/users/signin`, then
browses clusters, schedulers, seed peers, peers, jobs, applications and
models, and can submit preheat jobs — every call goes through the same
REST surface external clients use, so the console exercises nothing
private.
"""

CONSOLE_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>Dragonfly2-TPU Manager</title>
<style>
  :root { color-scheme: light dark; }
  body { font-family: system-ui, sans-serif; margin: 0; background: #f5f6f8; color: #1c2330; }
  header { background: #16324f; color: #fff; padding: 10px 20px; display: flex;
           align-items: center; gap: 16px; }
  header h1 { font-size: 16px; margin: 0; font-weight: 600; }
  header .who { margin-left: auto; font-size: 13px; opacity: .85; }
  nav { display: flex; gap: 4px; padding: 8px 16px; background: #fff;
        border-bottom: 1px solid #dde1e7; flex-wrap: wrap; }
  nav button { border: 0; background: none; padding: 8px 12px; cursor: pointer;
               font-size: 14px; border-radius: 6px; color: #3b4456; }
  nav button.on { background: #e8f0fe; color: #16324f; font-weight: 600; }
  main { padding: 16px 20px; }
  table { border-collapse: collapse; width: 100%; background: #fff;
          box-shadow: 0 1px 2px rgba(20,30,50,.08); border-radius: 8px; overflow: hidden; }
  th, td { text-align: left; padding: 8px 12px; border-bottom: 1px solid #eef0f4;
           font-size: 13px; vertical-align: top; max-width: 420px; overflow-wrap: anywhere; }
  th { background: #fafbfc; font-weight: 600; color: #5a6372; }
  .error { color: #b3261e; margin: 8px 0; }
  form.card, .card { background: #fff; padding: 16px; border-radius: 8px; max-width: 440px;
                     box-shadow: 0 1px 2px rgba(20,30,50,.08); margin-bottom: 16px; }
  input, select { padding: 7px 9px; margin: 4px 0; width: 100%; box-sizing: border-box;
                  border: 1px solid #cdd3dc; border-radius: 6px; font-size: 14px; }
  button.go { background: #16324f; color: #fff; border: 0; padding: 8px 14px;
              border-radius: 6px; cursor: pointer; margin-top: 8px; font-size: 14px; }
  .muted { color: #7a8394; font-size: 12px; }
</style>
</head>
<body>
<header><h1>Dragonfly2-TPU Manager</h1><span class="who" id="who"></span></header>
<nav id="nav" hidden></nav>
<main id="main"></main>
<script>
"use strict";
const GROUPS = ["overview", "clusters", "schedulers", "seed-peers", "peers",
                "jobs", "applications", "models"];
let token = null, user = null, tab = "overview";

async function api(method, path, body) {
  const headers = {"Content-Type": "application/json"};
  if (token) headers["Authorization"] = "Bearer " + token;
  const resp = await fetch("/api/v1/" + path, {
    method, headers, body: body === undefined ? undefined : JSON.stringify(body),
  });
  const data = await resp.json().catch(() => ({}));
  if (!resp.ok) {
    const err = new Error(data.error || resp.status);
    err.status = resp.status;  // message text alone can't signal auth
    throw err;
  }
  return data;
}

function el(tag, attrs, ...children) {
  const node = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs || {}))
    (k.startsWith("on")) ? node.addEventListener(k.slice(2), v) : node.setAttribute(k, v);
  for (const c of children)
    node.append(c instanceof Node ? c : document.createTextNode(String(c)));
  return node;
}

function renderLogin(message) {
  document.getElementById("nav").hidden = true;
  const main = document.getElementById("main");
  main.replaceChildren(el("form", {class: "card", onsubmit: async (e) => {
    e.preventDefault();
    try {
      const body = {name: e.target.name.value, password: e.target.password.value};
      token = (await api("POST", "users/signin", body)).token;
      user = body.name;
      renderApp();
    } catch (err) { renderLogin(String(err)); }
  }},
    el("h2", {}, "Sign in"),
    message ? el("div", {class: "error"}, message) : "",
    el("input", {name: "name", placeholder: "user (root)", required: ""}),
    el("input", {name: "password", type: "password", placeholder: "password", required: ""}),
    el("button", {class: "go"}, "Sign in"),
    el("div", {class: "muted"}, "default root / dragonfly")));
}

function renderApp() {
  document.getElementById("who").textContent = user || "";
  const nav = document.getElementById("nav");
  nav.hidden = false;
  nav.replaceChildren(...GROUPS.map(g =>
    el("button", {class: g === tab ? "on" : "", onclick: () => { tab = g; renderApp(); }}, g)),
    el("button", {onclick: () => { token = null; renderLogin(); }}, "sign out"));
  renderTab().catch(err =>
    document.getElementById("main").replaceChildren(el("div", {class: "error"}, String(err))));
}

async function renderTab() {
  const main = document.getElementById("main");
  if (tab === "overview") { main.replaceChildren(...await overview()); return; }
  const rows = await api("GET", tab);
  const children = [];
  if (tab === "jobs") children.push(preheatForm());
  if (!rows.length) {
    children.push(el("div", {class: "card"}, "no " + tab + " yet"));
  } else {
    const cols = [...new Set(rows.flatMap(r => Object.keys(r)))].slice(0, 9);
    const extra = tab === "models" ? 1 : 0;
    children.push(el("table", {},
      el("thead", {}, el("tr", {}, ...cols.map(c => el("th", {}, c)),
                         ...(extra ? [el("th", {}, "actions")] : []))),
      el("tbody", {}, ...rows.map(r => el("tr", {}, ...cols.map(c =>
        el("td", {}, r[c] === undefined ? "" :
          (typeof r[c] === "object" ? JSON.stringify(r[c]) : r[c]))),
        ...(extra ? [el("td", {}, modelActions(r))] : []))))));
  }
  main.replaceChildren(...children);
}

function modelActions(row) {
  // activate = the reference's version-policy flip (PATCH state: active)
  if (row.state === "active") return el("span", {class: "muted"}, "active");
  return el("button", {class: "go", onclick: async () => {
    try { await api("PATCH", "models/" + row.id, {state: "active"}); renderApp(); }
    catch (err) { alert(err); }
  }}, "activate");
}

async function overview() {
  // stat tiles + a scheduler-state bar, all through the public REST
  // surface; auth failures must NOT render as healthy-looking zeros
  const CAP = 1000;
  const groups = GROUPS.filter(g => g !== "overview");
  // every non-OK fetch (500, network) marks its tile "?" instead of
  // rendering 0 — a broken manager must not look like an empty-but-
  // healthy cluster; 401 still aborts to the login view
  const failed = {};
  const results = await Promise.all(groups.map(g =>
    api("GET", g + "?per_page=" + CAP).catch(err => {
      if (err.status === 401) throw err;  // never render auth failure as zeros
      failed[g] = String(err);
      return [];
    })));
  const counts = Object.fromEntries(groups.map((g, i) =>
    [g, failed[g] ? "?" : (results[i].length >= CAP ? CAP + "+" : results[i].length)]));
  const scheds = results[groups.indexOf("schedulers")];
  const active = scheds.filter(s => s.state === "active").length;
  const tiles = el("div", {style: "display:flex;gap:12px;flex-wrap:wrap;margin-bottom:16px"},
    ...groups.map(g => el("div", {class: "card", style: "max-width:130px;text-align:center",
        ...(failed[g] ? {title: failed[g]} : {})},
      el("div", {style: "font-size:26px;font-weight:700" +
        (failed[g] ? ";color:#b4231f" : "")}, counts[g]),
      el("div", {class: "muted"}, g))));
  const ns = "http://www.w3.org/2000/svg";
  // SVG elements need the SVG namespace: el() uses createElement, which
  // would yield an HTMLUnknownElement whose child rects never render
  const svg = document.createElementNS(ns, "svg");
  svg.setAttribute("width", "400"); svg.setAttribute("height", "28");
  svg.setAttribute("role", "img");
  svg.setAttribute("aria-label", active + " of " + scheds.length + " schedulers active");
  const total = Math.max(scheds.length, 1);
  const seg = (x, w, fill) => {
    const r = document.createElementNS(ns, "rect");
    r.setAttribute("x", x); r.setAttribute("y", 4);
    r.setAttribute("width", w); r.setAttribute("height", 18);
    r.setAttribute("rx", 4); r.setAttribute("fill", fill);
    svg.appendChild(r);
  };
  seg(0, 400, "#dde1e7");
  if (active) seg(0, 400 * active / total, "#2c7a4b");
  const bar = el("div", {class: "card"},
    el("h3", {style: "margin-top:0"}, "scheduler health"),
    svg,
    el("div", {class: "muted"}, failed["schedulers"]
       ? "unavailable: " + failed["schedulers"]
       : active + " active / " + (scheds.length - active) +
         " inactive of " + scheds.length));
  return [tiles, bar];
}

function preheatForm() {
  return el("form", {class: "card", onsubmit: async (e) => {
    e.preventDefault();
    try {
      await api("POST", "jobs", {type: "preheat", args: {
        type: e.target.ptype.value, url: e.target.url.value,
      }});
      renderApp();
    } catch (err) { alert(err); }
  }},
    el("h3", {}, "Preheat"),
    el("input", {name: "url", placeholder: "https://... (file or image manifest URL)", required: ""}),
    el("select", {name: "ptype"},
      el("option", {value: ""}, "auto"),
      el("option", {value: "file"}, "file"),
      el("option", {value: "image"}, "image")),
    el("button", {class: "go"}, "Create preheat job"));
}

renderLogin();
</script>
</body>
</html>
"""
