/* Generated config UI (reference shape:
 * OpenHome/Web/ConfigUi/res/webconfig.js + config.js + lp.js): the page
 * is built from the server's ConfigManager metadata (meta.json), every
 * value is rendered as a typed widget (num -> bounded number input,
 * choice -> select with language-resource display strings, text ->
 * maxlength input), value writes POST through the tab's send channel
 * and live updates arrive over the long-poll session.  No innerHTML
 * for dynamic data: keys/values are user data and must never parse as
 * HTML. */
'use strict';

var gSession = null;
var gPolling = false;

function langLookup(langText, key, value) {
  /* ConfigOptions.txt format (lang/<locale>/ConfigOptions.txt):
   *   Key.Name\n<value>\t<display>\n... blank-line separated */
  if (!langText) return null;
  var blocks = langText.split(/\n\s*\n/);
  for (var i = 0; i < blocks.length; i++) {
    var lines = blocks[i].split('\n').filter(function (l) { return l.trim(); });
    if (!lines.length || lines[0].trim() !== key) continue;
    for (var j = 1; j < lines.length; j++) {
      var m = lines[j].match(/^(\S+)\s+(.*)$/);
      if (m && m[1] === String(value)) return m[2];
    }
  }
  return null;
}

function sendMessage(msg) {
  if (gSession === null) return Promise.resolve();
  return fetch('send?session-id=' + gSession, {
    method: 'POST', body: JSON.stringify(msg)
  });
}

function makeWidget(meta, langText, statusEl) {
  var input;
  if (meta.type === 'choice') {
    input = document.createElement('select');
    /* choices arrive as {id: name} (ConfigChoice) or as a plain list */
    var entries = Array.isArray(meta.choices)
      ? meta.choices.map(function (c) { return [c, c]; })
      : Object.entries(meta.choices || {});
    entries.forEach(function (kv) {
      var opt = document.createElement('option');
      opt.value = String(kv[0]);
      opt.textContent = langLookup(langText, meta.key, kv[0])
        || langLookup(langText, meta.key, kv[1]) || String(kv[1]);
      input.appendChild(opt);
    });
    input.value = String(meta.value);
  } else if (meta.type === 'num') {
    input = document.createElement('input');
    input.type = 'number';
    if (meta.min !== undefined) input.min = meta.min;
    if (meta.max !== undefined) input.max = meta.max;
    input.value = String(meta.value);
  } else {
    input = document.createElement('input');
    input.type = 'text';
    if (meta.maxLength) input.maxLength = meta.maxLength;
    input.value = String(meta.value);
  }
  input.id = 'cfg-' + meta.key;
  input.onchange = function () {
    var v = input.value;
    if (meta.type === 'num') {
      var n = Number(v);
      if (!Number.isFinite(n) || (meta.min !== undefined && n < meta.min)
          || (meta.max !== undefined && n > meta.max)) {
        statusEl.textContent = 'out of range [' + meta.min + ', '
          + meta.max + ']';
        return;
      }
      v = n;
    }
    statusEl.textContent = '';
    sendMessage({ type: 'set', key: meta.key, value: v });
  };
  return input;
}

function buildPage(metas, langText) {
  var body = document.body;
  while (body.firstChild) body.removeChild(body.firstChild);
  var h1 = document.createElement('h1');
  h1.textContent = 'Configuration';
  body.appendChild(h1);
  var table = document.createElement('table');
  table.id = 'ConfigValContainer';
  var widgets = new Map();
  metas.forEach(function (meta) {
    var tr = document.createElement('tr');
    var td1 = document.createElement('td');
    td1.textContent = meta.key;
    var td2 = document.createElement('td');
    var td3 = document.createElement('td');
    td3.className = 'status';
    var w = makeWidget(meta, langText, td3);
    td2.appendChild(w);
    tr.appendChild(td1);
    tr.appendChild(td2);
    tr.appendChild(td3);
    table.appendChild(tr);
    widgets.set(meta.key, { input: w, status: td3, meta: meta });
  });
  body.appendChild(table);
  var reboot = document.createElement('button');
  reboot.type = 'button';
  reboot.id = 'RebootButton';
  reboot.textContent = 'Reboot';
  reboot.onclick = function () { sendMessage({ type: 'reboot' }); };
  body.appendChild(reboot);
  return widgets;
}

function applyMessage(widgets, m) {
  var w = widgets.get(m.key);
  if (!w) return;
  if (m.type === 'update') {
    if (document.activeElement !== w.input)
      w.input.value = String(m.value);
    w.status.textContent = '';
  } else if (m.type === 'error') {
    w.status.textContent = m.description || 'rejected';
  }
}

async function StartLongPolling() {
  var metas, langText = null;
  try {
    metas = await (await fetch('meta.json')).json();
    try {
      var lr = await fetch('ConfigOptions.txt',
                           { headers: { 'Accept-Language': 'en-gb' } });
      if (lr.ok) langText = await lr.text();
    } catch (e) { /* language resource optional */ }
    gSession = (await (await fetch('lpcreate')).json())['session-id'];
  } catch (e) {
    document.body.textContent =
      'Attempting to establish connection to device...';
    setTimeout(StartLongPolling, 2000);
    return;
  }
  var widgets = buildPage(metas, langText);
  gPolling = true;
  while (gPolling) {
    var msgs;
    try {
      msgs = await (await fetch('lp?session-id=' + gSession)).json();
    } catch (e) {
      break;                       /* session reaped or server gone */
    }
    msgs.forEach(function (m) { applyMessage(widgets, m); });
  }
}

function EndLongPolling() {
  gPolling = false;
  if (gSession !== null && navigator.sendBeacon)
    navigator.sendBeacon('lpterminate?session-id=' + gSession);
  gSession = null;
}
