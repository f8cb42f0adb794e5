"""Built-in single-page web UI.

Counterpart of ``semcode_tpu/frontend/webui.py``; ``INDEX_HTML`` is copied
verbatim, so both packages serve the same page at ``/``: API root/key
configuration, repository + language filters populated from ``/repos``,
query history with replay (persisted in localStorage), fallback warning,
sources rendered as code blocks, and a unified-diff compare of any two
snippets — a dependency-free HTML page served by the API itself.
"""

INDEX_HTML = r"""<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>semcode-tpu · semantic code search</title>
<style>
  :root { --bg:#0f1115; --panel:#181b22; --line:#2a2f3a; --fg:#d7dce3;
          --dim:#8b93a1; --acc:#4f9cf9; --warn:#e5b454; }
  * { box-sizing:border-box; }
  body { margin:0; background:var(--bg); color:var(--fg);
         font:14px/1.5 system-ui, sans-serif; display:flex; min-height:100vh; }
  aside { width:280px; padding:16px; background:var(--panel);
          border-right:1px solid var(--line); }
  main { flex:1; padding:24px; max-width:980px; }
  h1 { font-size:18px; margin:0 0 16px; }
  h2 { font-size:13px; text-transform:uppercase; color:var(--dim); margin:18px 0 6px; }
  input, textarea, select, button {
    width:100%; background:#10131a; color:var(--fg); border:1px solid var(--line);
    border-radius:6px; padding:8px; font:inherit; margin-bottom:8px; }
  button { background:var(--acc); color:#fff; border:none; cursor:pointer; width:auto;
           padding:8px 18px; }
  button.ghost { background:transparent; border:1px solid var(--line); color:var(--fg); }
  pre { background:#10131a; border:1px solid var(--line); border-radius:6px;
        padding:10px; overflow:auto; font:12px/1.45 ui-monospace, monospace; }
  .src { margin-bottom:14px; }
  .src header { display:flex; justify-content:space-between; color:var(--dim);
                font-size:12px; margin-bottom:4px; }
  .warn { background:#3a2f18; border:1px solid var(--warn); color:var(--warn);
          padding:8px 12px; border-radius:6px; margin-bottom:12px; }
  .hist { cursor:pointer; color:var(--acc); font-size:13px; margin:2px 0; }
  .del { color:#f55; } .add { color:#6c6; } .ctx { color:var(--dim); }
  label { font-size:12px; color:var(--dim); }
  .answer { background:var(--panel); border:1px solid var(--line); border-radius:8px;
            padding:14px 16px; margin:12px 0; white-space:pre-wrap; }
  .row { display:flex; gap:8px; }
</style>
</head>
<body>
<aside>
  <h1>semcode-tpu</h1>
  <h2>API</h2>
  <label>API root</label><input id="apiRoot" value="">
  <label>API key (X-API-Key)</label><input id="apiKey" type="password">
  <h2>Filters</h2>
  <label>Repositories</label><select id="repoFilter" multiple size="4"></select>
  <label>Languages</label><select id="langFilter" multiple size="4"></select>
  <button class="ghost" onclick="loadRepos()">Load filters</button>
  <h2>History</h2>
  <div id="history"></div>
</aside>
<main>
  <h2>Question</h2>
  <textarea id="question" rows="3"
    placeholder="How does the ingestion pipeline chunk C++ files?"></textarea>
  <div class="row">
    <button onclick="runQuery()">Search</button>
    <button class="ghost" onclick="clearResult()">Clear</button>
  </div>
  <div id="result"></div>
  <h2 id="diffHead" style="display:none">Compare snippets</h2>
  <div class="row" id="diffPick" style="display:none">
    <select id="diffA"></select><select id="diffB"></select>
    <button class="ghost" onclick="renderDiff()">Diff</button>
  </div>
  <pre id="diff" style="display:none"></pre>
  <h2>Browse chunks</h2>
  <div class="row">
    <button class="ghost" onclick="browseChunks(0)">Browse selected repos</button>
    <button class="ghost" id="browsePrev" style="display:none"
            onclick="browseChunks(browseOffset - 50)">Prev</button>
    <button class="ghost" id="browseNext" style="display:none"
            onclick="browseChunks(browseOffset + 50)">Next</button>
  </div>
  <div id="browse"></div>
</main>
<script>
const $ = id => document.getElementById(id);
let lastSources = [];
let browseOffset = 0;

async function browseChunks(offset) {
  browseOffset = Math.max(0, offset);
  const repoSel = selected($('repoFilter'));
  try {
    // /chunks takes one scalar repo param: with a multi-select, fetch each
    // selected repo and merge (never silently drop the filter)
    const repos = repoSel.length ? repoSel : [null];
    const per = Math.max(1, Math.floor(50 / repos.length));
    let rows = [];
    for (const repo of repos) {
      const params = new URLSearchParams({offset: browseOffset, limit: per});
      if (repo !== null) params.set('repo', repo);
      const r = await fetch(apiRoot() + '/chunks?' + params, {headers: headers()});
      const part = await r.json();
      if (!r.ok) throw new Error(part.detail || r.status);
      rows = rows.concat(part);
    }
    let html = '<table style="width:100%;font-size:13px;border-collapse:collapse">' +
      '<tr class="ctx"><td>repo</td><td>path</td><td>lines</td><td>symbol</td></tr>';
    rows.forEach(c => {
      html += '<tr><td>' + escapeHtml(c.repo || '') + '</td><td>' +
        escapeHtml(c.path || '') + '</td><td>' + (c.start_line || '') + '-' +
        (c.end_line || '') + '</td><td>' + escapeHtml(c.symbol || '') + '</td></tr>';
    });
    html += '</table>';
    $('browse').innerHTML = rows.length ? html :
      '<p class="ctx">No chunks' + (browseOffset ? ' at this offset' : '') + '.</p>';
    $('browsePrev').style.display = browseOffset > 0 ? '' : 'none';
    $('browseNext').style.display = rows.length >= per ? '' : 'none';
  } catch (e) { $('browse').innerHTML = '<div class="warn">Browse failed: ' + escapeHtml(String(e)) + '</div>'; }
}

function headers() {
  const h = {'Content-Type': 'application/json'};
  const k = $('apiKey').value.trim();
  if (k) h['X-API-Key'] = k;
  return h;
}
function apiRoot() { return $('apiRoot').value.trim() || ''; }

async function loadRepos() {
  try {
    const r = await fetch(apiRoot() + '/repos', {headers: headers()});
    const repos = await r.json();
    const langs = new Set();
    $('repoFilter').innerHTML = '';
    repos.forEach(x => {
      const o = document.createElement('option');
      o.value = o.textContent = x.name; $('repoFilter').appendChild(o);
      (x.languages || []).forEach(l => langs.add(l));
    });
    $('langFilter').innerHTML = '';
    [...langs].sort().forEach(l => {
      const o = document.createElement('option');
      o.value = o.textContent = l; $('langFilter').appendChild(o);
    });
  } catch (e) { alert('Failed to load /repos: ' + e); }
}

function getHistory() {
  try { return JSON.parse(localStorage.getItem('semcode_history') || '[]'); }
  catch { return []; }
}
function pushHistory(q) {
  const h = getHistory().filter(x => x !== q); h.unshift(q);
  localStorage.setItem('semcode_history', JSON.stringify(h.slice(0, 20)));
  renderHistory();
}
function renderHistory() {
  $('history').innerHTML = '';
  getHistory().forEach(q => {
    const d = document.createElement('div');
    d.className = 'hist'; d.textContent = q.slice(0, 60);
    d.onclick = () => { $('question').value = q; runQuery(); };
    $('history').appendChild(d);
  });
}

function selected(sel) {
  return [...sel.selectedOptions].map(o => o.value);
}

async function runQuery() {
  const q = $('question').value.trim();
  if (!q) return;
  $('result').innerHTML = '<p class="ctx">Searching…</p>';
  try {
    // push repo/language filters into the query so retrieval searches the
    // filtered subset on device (server-side tag mask), instead of merely
    // hiding off-filter results client-side after retrieval
    const body = {question: q};
    const filters = {};
    const repoSel = selected($('repoFilter')), langSel = selected($('langFilter'));
    if (repoSel.length) filters.repo = repoSel;
    if (langSel.length) filters.language = langSel;
    if (Object.keys(filters).length) body.filters = filters;
    const r = await fetch(apiRoot() + '/query', {
      method: 'POST', headers: headers(), body: JSON.stringify(body)});
    const data = await r.json();
    if (!r.ok) throw new Error(data.detail || r.status);
    pushHistory(q);
    render(data);
  } catch (e) { $('result').innerHTML = '<div class="warn">Query failed: ' + escapeHtml(String(e)) + '</div>'; }
}

function render(data) {
  const repoSel = selected($('repoFilter')), langSel = selected($('langFilter'));
  let srcs = data.sources || [];
  if (repoSel.length) srcs = srcs.filter(s => repoSel.includes(s.repo));
  if (langSel.length) srcs = srcs.filter(s => langSel.includes(s.language));
  lastSources = srcs;
  let html = '';
  if (data.meta && data.meta.fallback_used)
    html += '<div class="warn">Fallback answer (' + escapeHtml(data.meta.reason || 'LLM unavailable') + ')</div>';
  html += '<div class="answer">' + escapeHtml(data.answer || '') + '</div>';
  srcs.forEach((s, i) => {
    html += '<div class="src"><header><span>' + (i + 1) + '. ' +
      escapeHtml((s.repo || '') + '/' + (s.path || '')) + ' · ' + escapeHtml(s.language || '') +
      '</span><span>score ' + (s.score == null ? '—' : s.score.toFixed(4)) +
      '</span></header><pre>' + escapeHtml(s.snippet || '') + '</pre></div>';
  });
  $('result').innerHTML = html;
  setupDiff(srcs);
}

function setupDiff(srcs) {
  const show = srcs.length >= 2;
  $('diffHead').style.display = $('diffPick').style.display = show ? '' : 'none';
  $('diff').style.display = 'none';
  if (!show) return;
  [$('diffA'), $('diffB')].forEach(sel => {
    sel.innerHTML = '';
    srcs.forEach((s, i) => {
      const o = document.createElement('option');
      o.value = i; o.textContent = (i + 1) + '. ' + (s.path || '');
      sel.appendChild(o);
    });
  });
  $('diffB').selectedIndex = 1;
}

function renderDiff() {
  const a = (lastSources[$('diffA').value]?.snippet || '').split('\n');
  const b = (lastSources[$('diffB').value]?.snippet || '').split('\n');
  $('diff').style.display = '';
  $('diff').innerHTML = unifiedDiff(a, b).map(l =>
    '<span class="' + (l[0] === '+' ? 'add' : l[0] === '-' ? 'del' : 'ctx') + '">' +
    escapeHtml(l) + '</span>').join('\n');
}

// minimal LCS-based unified diff
function unifiedDiff(a, b) {
  const n = a.length, m = b.length;
  const dp = Array.from({length: n + 1}, () => new Array(m + 1).fill(0));
  for (let i = n - 1; i >= 0; i--)
    for (let j = m - 1; j >= 0; j--)
      dp[i][j] = a[i] === b[j] ? dp[i+1][j+1] + 1 : Math.max(dp[i+1][j], dp[i][j+1]);
  const out = []; let i = 0, j = 0;
  while (i < n && j < m) {
    if (a[i] === b[j]) { out.push(' ' + a[i]); i++; j++; }
    else if (dp[i+1][j] >= dp[i][j+1]) out.push('-' + a[i++]);
    else out.push('+' + b[j++]);
  }
  while (i < n) out.push('-' + a[i++]);
  while (j < m) out.push('+' + b[j++]);
  return out;
}

function escapeHtml(s) {
  return (s || '').replace(/[&<>"']/g, c =>
    ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
}
function clearResult() { $('result').innerHTML = ''; $('diff').style.display = 'none';
  $('diffHead').style.display = $('diffPick').style.display = 'none'; }

renderHistory();
loadRepos();
</script>
</body>
</html>
"""
