"""Built-in chat web UI (port of eagle_tpu/server/webui.py, the page as it
is): one static page served from GET /, speaking the OpenAI-compatible
/v1/chat/completions endpoint with SSE streaming, no build step, no
external assets."""

INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>eagle-tpu server</title>
<style>
  :root { color-scheme: light dark; }
  * { box-sizing: border-box; }
  body { font: 15px/1.5 system-ui, sans-serif; margin: 0; display: flex;
         flex-direction: column; height: 100vh;
         background: Canvas; color: CanvasText; }
  header { padding: .6rem 1rem; border-bottom: 1px solid color-mix(in srgb, CanvasText 15%, Canvas);
           display: flex; gap: 1rem; align-items: baseline; }
  header h1 { font-size: 1rem; margin: 0; }
  header .meta { opacity: .6; font-size: .8rem; }
  #log { flex: 1; overflow-y: auto; padding: 1rem; display: flex;
         flex-direction: column; gap: .75rem; }
  .msg { max-width: 46rem; padding: .5rem .8rem; border-radius: .6rem;
         white-space: pre-wrap; word-break: break-word; }
  .user { align-self: flex-end; background: color-mix(in srgb, CanvasText 10%, Canvas); }
  .assistant { align-self: flex-start; background: color-mix(in srgb, CanvasText 5%, Canvas);
               border: 1px solid color-mix(in srgb, CanvasText 12%, Canvas); }
  .sys { align-self: center; opacity: .55; font-size: .8rem; }
  form { display: flex; gap: .5rem; padding: .75rem 1rem; border-top:
         1px solid color-mix(in srgb, CanvasText 15%, Canvas); }
  textarea { flex: 1; resize: none; font: inherit; padding: .5rem .7rem;
             border-radius: .6rem; border: 1px solid color-mix(in srgb, CanvasText 25%, Canvas);
             background: Canvas; color: CanvasText; }
  button { font: inherit; padding: .5rem 1.1rem; border-radius: .6rem;
           border: none; background: color-mix(in srgb, CanvasText 80%, Canvas);
           color: Canvas; cursor: pointer; }
  button:disabled { opacity: .4; cursor: default; }
  details { padding: .3rem 1rem; font-size: .85rem; }
  details label { margin-right: 1rem; }
  details input { width: 4.5rem; }
</style>
</head>
<body>
<header>
  <h1>eagle-tpu</h1>
  <span class="meta" id="model">…</span>
</header>
<details>
  <summary>sampling</summary>
  <label>temperature <input id="temp" type="number" step="0.1" value="0.8"></label>
  <label>top_k <input id="topk" type="number" value="40"></label>
  <label>top_p <input id="topp" type="number" step="0.05" value="0.95"></label>
  <label>max tokens <input id="maxtok" type="number" value="256"></label>
</details>
<div id="log"><div class="msg sys">ready</div></div>
<form id="f">
  <textarea id="in" rows="2" placeholder="Say something… (Enter to send, Shift+Enter for newline)"></textarea>
  <button id="send" type="submit">Send</button>
</form>
<script>
const log = document.getElementById('log');
const input = document.getElementById('in');
const send = document.getElementById('send');
const messages = [];

fetch('/props').then(r => r.json()).then(p => {
  document.getElementById('model').textContent =
    `${p.model} · ctx ${p.n_ctx}` + (p.speculative ? ' · EAGLE' : '');
}).catch(() => {});

function add(role, text) {
  const d = document.createElement('div');
  d.className = 'msg ' + role;
  d.textContent = text;
  log.appendChild(d);
  log.scrollTop = log.scrollHeight;
  return d;
}

async function ask(text) {
  messages.push({role: 'user', content: text});
  add('user', text);
  const out = add('assistant', '');
  send.disabled = true;
  try {
    const res = await fetch('/v1/chat/completions', {
      method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({
        messages,
        stream: true,
        temperature: +document.getElementById('temp').value,
        top_k: +document.getElementById('topk').value,
        top_p: +document.getElementById('topp').value,
        max_tokens: +document.getElementById('maxtok').value,
      }),
    });
    if (!res.ok) throw new Error(await res.text());
    const reader = res.body.getReader();
    const dec = new TextDecoder();
    let buf = '';
    for (;;) {
      const {done, value} = await reader.read();
      if (done) break;
      buf += dec.decode(value, {stream: true});
      let i;
      while ((i = buf.indexOf('\\n\\n')) >= 0) {
        const line = buf.slice(0, i).trim();
        buf = buf.slice(i + 2);
        if (!line.startsWith('data:')) continue;
        const payload = line.slice(5).trim();
        if (payload === '[DONE]') continue;
        try {
          const delta = JSON.parse(payload).choices?.[0]?.delta?.content;
          if (delta) { out.textContent += delta; log.scrollTop = log.scrollHeight; }
        } catch (e) {}
      }
    }
    messages.push({role: 'assistant', content: out.textContent});
  } catch (e) {
    out.textContent += `\\n[error] ${e.message}`;
  } finally {
    send.disabled = false;
    input.focus();
  }
}

document.getElementById('f').addEventListener('submit', ev => {
  ev.preventDefault();
  const text = input.value.trim();
  if (!text || send.disabled) return;
  input.value = '';
  ask(text);
});
input.addEventListener('keydown', ev => {
  if (ev.key === 'Enter' && !ev.shiftKey) {
    ev.preventDefault();
    document.getElementById('f').requestSubmit();
  }
});
</script>
</body>
</html>
"""
