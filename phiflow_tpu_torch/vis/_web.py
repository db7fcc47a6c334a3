"""Built-in web GUI — port of `phiflow_tpu/vis/_web.py`: live field views,
play / pause / step, control sliders, scalar curves, a step benchmark and a
profiler trace, served by the standard library's ``http.server``. Plots are
rendered on the server with the matplotlib recipes and streamed as PNG; the
page polls with fetch(). The profiler page traces steps with
`torch.profiler` (`utils.profile`: a Chrome trace), the system page lists
torch's devices.

Usage::

    viewer = vis.view(play=False)
    gui = WebGui(port=8050)
    gui.setup(viewer)
    gui.show(block=False)       # serve http://localhost:8050
"""
from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse, parse_qs

import torch

from ._matplotlib_plots import _pyplot
from ._vis_base import Gui, VisModel, play_async, benchmark, display_name

__all__ = ['WebGui', 'web_view']

_PAGE = """<!DOCTYPE html>
<html><head><title>{title}</title>
<style>
 body {{ font-family: sans-serif; margin: 1.5em; background: #fafafa; }}
 button {{ margin: 0 .2em; padding: .4em 1em; }}
 img {{ border: 1px solid #ccc; background: white; max-width: 95vw; }}
 .ctl {{ margin: .4em 0; }}
 #status {{ color: #666; margin-left: 1em; }}
</style></head>
<body>
<h2>{title}</h2>
<div>
 <button onclick="api('play')">&#9654; Play</button>
 <button onclick="api('pause')">&#10074;&#10074; Pause</button>
 <button onclick="api('step')">Step</button>
 <span id="status"></span>
</div>
<div class="ctl" id="controls"></div>
<div class="ctl">Field:
 <select id="field" onchange="refresh()">{options}</select>
</div>
<img id="plot" src="/plot?field={first}">
<h3>Scalars</h3>
<img id="curves" src="/curves">
<p>
 <a href="/side-by-side">Side-by-Side</a> &middot;
 <a href="/quad">Quad</a> &middot;
 <a href="/info">Info</a> &middot;
 <a href="/log">Log</a> &middot;
 <a href="/board">&Phi; Board (benchmark / profiler / system)</a>
</p>
<script>
 const fieldSel = document.getElementById('field');
 function refresh() {{
   const f = fieldSel.value;
   document.getElementById('plot').src = '/plot?field=' + f + '&t=' + Date.now();
   document.getElementById('curves').src = '/curves?t=' + Date.now();
 }}
 async function api(cmd) {{ await fetch('/api/' + cmd, {{method: 'POST'}}); poll(); }}
 async function setControl(name, value) {{
   await fetch('/api/control?name=' + name + '&value=' + value, {{method: 'POST'}});
 }}
 async function poll() {{
   const r = await fetch('/api/status'); const s = await r.json();
   document.getElementById('status').textContent = 'step ' + s.steps;
   if (s.playing) refresh();
 }}
 async function initControls() {{
   const r = await fetch('/api/status'); const s = await r.json();
   const div = document.getElementById('controls');
   div.innerHTML = s.controls.map(c =>
     `<label>${{c.name}}: <input type="range" min="${{c.lo}}" max="${{c.hi}}" step="${{c.step}}"
       value="${{c.value}}" onchange="setControl('${{c.name}}', this.value)">
       <span>${{c.value}}</span></label><br>`).join('');
 }}
 initControls(); setInterval(poll, 1000);
</script>
</body></html>
"""


_BOARD_PAGE = """<!DOCTYPE html>
<html><head><title>{title} — &Phi; Board</title>
<style>
 body {{ font-family: sans-serif; margin: 1.5em; background: #fafafa; }}
 button {{ margin: 0 .2em; padding: .4em 1em; }}
 table {{ border-collapse: collapse; }} td, th {{ border: 1px solid #ccc; padding: .3em .8em; }}
 pre {{ background: #eee; padding: .6em; }}
</style></head>
<body>
<h2>&Phi; Board — {title}</h2>
<p><a href="/">&larr; back to viewer</a></p>
<h3>Step benchmark</h3>
<button onclick="bench(10)">Benchmark 10 steps</button>
<button onclick="bench(100)">Benchmark 100 steps</button>
<table id="bench"><tr><th>steps</th><th>total&nbsp;s</th><th>ms/step</th></tr></table>
<h3>Profiler</h3>
<p>(captures a <code>torch.profiler</code> trace: a Chrome trace, viewable in Perfetto or chrome://tracing)</p>
<button onclick="profile(5)">Trace 5 steps</button>
<pre id="profout">no trace captured yet</pre>
<h3>System</h3>
<pre id="sysinfo">loading&hellip;</pre>
<script>
 async function bench(n) {{
   const r = await fetch('/api/benchmark?n=' + n, {{method: 'POST'}});
   const s = await r.json();
   document.getElementById('bench').innerHTML +=
     `<tr><td>${{s.steps}}</td><td>${{s.seconds.toFixed(3)}}</td><td>${{s.ms_per_step.toFixed(2)}}</td></tr>`;
 }}
 async function profile(n) {{
   document.getElementById('profout').textContent = 'tracing...';
   const r = await fetch('/api/profile?n=' + n, {{method: 'POST'}});
   const s = await r.json();
   document.getElementById('profout').textContent = JSON.stringify(s, null, 1);
 }}
 async function sysinfo() {{
   const r = await fetch('/api/sysinfo'); const s = await r.json();
   document.getElementById('sysinfo').textContent = JSON.stringify(s, null, 1);
 }}
 sysinfo();
</script>
</body></html>
"""


_MULTI_PAGE = """<!DOCTYPE html>
<html><head><title>{title} — {label}</title>
<style>
 body {{ font-family: sans-serif; margin: 1.5em; background: #fafafa; }}
 button {{ margin: 0 .2em; padding: .4em 1em; }}
 img {{ border: 1px solid #ccc; background: white; width: 100%; }}
 .view {{ display: inline-block; width: {width}; vertical-align: top; padding: .3em; box-sizing: border-box; }}
 #status {{ color: #666; margin-left: 1em; }}
</style></head>
<body>
<h2>{title} — {label}</h2>
<p><a href="/">&larr; home</a></p>
<div>
 <button onclick="api('play')">&#9654; Play</button>
 <button onclick="api('pause')">&#10074;&#10074; Pause</button>
 <button onclick="api('step')">Step</button>
 <span id="status"></span>
</div>
<div id="views">{views}</div>
<script>
 function refresh() {{
   document.querySelectorAll('.view').forEach((v, i) => {{
     const f = v.querySelector('select').value;
     v.querySelector('img').src = '/plot?field=' + f + '&t=' + Date.now();
   }});
 }}
 async function api(cmd) {{ await fetch('/api/' + cmd, {{method: 'POST'}}); poll(); }}
 async function poll() {{
   const r = await fetch('/api/status'); const s = await r.json();
   document.getElementById('status').textContent = 'step ' + s.steps;
   if (s.playing) refresh();
 }}
 setInterval(poll, 1000);
</script>
</body></html>
"""

_LOG_PAGE = """<!DOCTYPE html>
<html><head><title>{title} — Log</title>
<style> body {{ font-family: sans-serif; margin: 1.5em; background: #fafafa; }}
 pre {{ background: #f0f0f0; padding: .8em; white-space: pre-wrap; }}</style></head>
<body>
<h2>{title} — Log</h2>
<p><a href="/">&larr; home</a> <button onclick="load()">Refresh</button></p>
<pre id="log">loading&hellip;</pre>
<script>
 async function load() {{
   const r = await fetch('/api/log'); const s = await r.json();
   document.getElementById('log').textContent = s.text;
 }}
 load();
</script>
</body></html>
"""

_INFO_PAGE = """<!DOCTYPE html>
<html><head><title>{title} — Info</title>
<style> body {{ font-family: sans-serif; margin: 1.5em; background: #fafafa; }}
 table {{ border-collapse: collapse; }} td, th {{ border: 1px solid #ccc; padding: .3em .8em; text-align: left; }}
 blockquote {{ background: #f0f0f0; padding: .6em 1em; }}</style></head>
<body>
<h2>{title}</h2>
<p><a href="/">&larr; home</a></p>
<blockquote>{description}</blockquote>
<table>{rows}</table>
<p id="clock"></p>
<script>
 const started = {start_time};
 function tick() {{
   const el = (Date.now()/1000 - started) | 0;
   document.getElementById('clock').textContent =
     'Running for ' + ((el/60)|0) + ' minutes and ' + (el%60) + ' seconds';
 }}
 tick(); setInterval(tick, 1000);
</script>
</body></html>
"""


def _devices():
    """torch's devices by name: the CPU, then each card with its name."""
    return ['cpu'] + [f'cuda:{i} ({torch.cuda.get_device_name(i)})' for i in range(torch.cuda.device_count())]


class WebGui(Gui):
    """Std-lib HTTP web interface over a `VisModel`: the home page, Side-by-Side,
    Quad, Info, Log and the Φ-Board (benchmark, profiler, system)."""

    def __init__(self, port: int = 8050, host: str = '127.0.0.1'):
        super().__init__(asynchronous=True)
        self.port = port
        self.host = host
        self._server = None
        self._play = None
        self._thread = None

    # ----- rendering -----

    def _render_field_png(self, name: str) -> bytes:
        from ._vis import plot
        data = self.app.get_field(name, {})
        fig = plot(data)
        buf = io.BytesIO()
        fig.savefig(buf, format='png', dpi=100)
        _pyplot().close(fig)
        return buf.getvalue()

    def _render_curves_png(self) -> bytes:
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(8, 3))
        names = self.app.curve_names
        for cn in names:
            try:
                frames, values = self.app.get_curve(cn)
                ax.plot(frames, values, label=cn)
            except Exception:
                pass
        if names:
            ax.legend(loc='best', fontsize=8)
        ax.set_xlabel('step')
        buf = io.BytesIO()
        fig.savefig(buf, format='png', dpi=100)
        plt.close(fig)
        return buf.getvalue()

    # ----- control -----

    def _status(self) -> dict:
        controls = []
        for c in self.app.controls:
            lo, hi = c.value_range if c.value_range else (0, max(1, 2 * (c.initial or 1)))
            controls.append({'name': c.name, 'value': c.value, 'lo': lo, 'hi': hi,
                             'step': (hi - lo) / 100 if c.control_type is float else 1})
        return {'steps': self.app.steps, 'playing': self._play is not None,
                'fields': list(self.app.field_names), 'controls': controls}

    def _handle_api(self, cmd: str, query: dict) -> dict:
        if cmd == 'status':
            return self._status()
        if cmd == 'play':
            if self._play is None:
                self._play = play_async(self.app, framerate=self.config.get('framerate'))
            return {'ok': True}
        if cmd == 'pause':
            if self._play is not None:
                self._play.pause()
                self._play = None
            return {'ok': True}
        if cmd == 'step':
            self.app.progress()
            return {'ok': True, 'steps': self.app.steps}
        if cmd == 'benchmark':
            n = int(query.get('n', ['10'])[0])
            steps, elapsed = benchmark(self.app, n)
            return {'steps': steps, 'seconds': elapsed, 'ms_per_step': 1000 * elapsed / max(1, steps)}
        if cmd == 'profile':
            # a torch.profiler trace over n steps (the Φ-Board's profiler page)
            import os
            import tempfile
            import time as _time
            from ..utils import profile
            n = int(query.get('n', ['5'])[0])
            trace_dir = query.get('dir', [None])[0] or os.path.join(tempfile.gettempdir(), 'phiflow_tpu_torch_trace')
            t0 = _time.perf_counter()
            with profile(trace_dir):
                for _ in range(n):
                    self.app.progress()
            elapsed = _time.perf_counter() - t0
            return {'steps': n, 'seconds': elapsed, 'trace_dir': trace_dir,
                    'hint': f'open {os.path.join(trace_dir, "trace.json")} in Perfetto or chrome://tracing'}
        if cmd == 'sysinfo':
            devs = _devices()
            info = {'backend': 'cuda' if torch.cuda.is_available() else 'cpu', 'devices': devs,
                    'device_count': len(devs)}
            if torch.cuda.is_available():
                info['memory'] = {'allocated_bytes': torch.cuda.memory_allocated(),
                                  'reserved_bytes': torch.cuda.memory_reserved()}
            return info
        if cmd == 'control':
            name = query['name'][0]
            for c in self.app.controls:
                if c.name == name:
                    c.value = query['value'][0]
                    return {'ok': True, 'value': c.value}
            return {'ok': False, 'error': f'no control {name}'}
        if cmd == 'action':
            name = query['name'][0]
            for a in self.app.actions:
                if a.name == name:
                    a()
                    return {'ok': True}
            return {'ok': False, 'error': f'no action {name}'}
        if cmd == 'log':
            # the scene's info.log
            import os
            log_file = getattr(self.app, 'log_file', None)
            if log_file is None and getattr(self.app, 'scene', None) is not None:
                log_file = os.path.join(self.app.scene.path, 'info.log')
            if log_file and os.path.isfile(log_file):
                with open(log_file) as stream:
                    return {'text': stream.read()}
            return {'text': 'Log not available. Pass scene=True or an existing Scene '
                            'to view() to enable logging.'}
        return {'ok': False, 'error': f'unknown command {cmd}'}

    # ----- multi-view / info pages -----

    def _multi_page(self, n: int, label: str) -> str:
        fields = list(self.app.field_names)
        views = []
        for i in range(n):
            f0 = fields[i % len(fields)] if fields else ''
            options = ''.join(
                f'<option value="{f}"{" selected" if f == f0 else ""}>{display_name(f)}</option>'
                for f in fields)
            views.append(f'<div class="view"><select onchange="refresh()">{options}</select>'
                         f'<img src="/plot?field={f0}"></div>')
        return _MULTI_PAGE.format(title=self.app.name, label=label, width='49%',
                                  views=''.join(views))

    def _info_page(self) -> str:
        import html as _html
        import os
        import socket
        import sys
        from .. import __version__ as _version
        scene = getattr(self.app, 'scene', None)
        rows = [
            ('Host', socket.gethostname()),
            ('Script', os.path.abspath(sys.argv[0]) if sys.argv else '—'),
            ('Data path', scene.path if scene is not None else '—'),
            ('Framework', f'phiflow-tpu-torch {_version}, torch {torch.__version__}'),
            ('Backend', 'cuda' if torch.cuda.is_available() else 'cpu'),
            ('Devices', ', '.join(_devices())),
            ('Fields', ', '.join(self.app.field_names)),
            ('Controls', ', '.join(c.name for c in self.app.controls) or '—'),
            ('Actions', ', '.join(a.name for a in self.app.actions) or '—'),
            ('Steps', str(self.app.steps)),
        ]
        row_html = ''.join(f'<tr><th>{k}</th><td>{_html.escape(str(v))}</td></tr>' for k, v in rows)
        import time as _time
        start = getattr(self.app, 'start_time', None) or _time.time()
        return _INFO_PAGE.format(title=self.app.name,
                                 description=_html.escape(self.app.description or 'No description.'),
                                 rows=row_html, start_time=start)

    # ----- server -----

    def _make_handler(gui):  # noqa: N805 — closure over the gui instance
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass  # silent

            def _send(self, payload: bytes, ctype: str, code=200):
                self.send_response(code)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                url = urlparse(self.path)
                query = parse_qs(url.query)
                try:
                    if url.path == '/':
                        fields = gui.app.field_names
                        options = ''.join(f'<option value="{f}">{display_name(f)}</option>' for f in fields)
                        page = _PAGE.format(title=gui.app.name, options=options,
                                            first=fields[0] if fields else '')
                        self._send(page.encode(), 'text/html')
                    elif url.path == '/board':
                        self._send(_BOARD_PAGE.format(title=gui.app.name).encode(), 'text/html')
                    elif url.path == '/side-by-side':
                        self._send(gui._multi_page(2, 'Side-by-Side').encode(), 'text/html')
                    elif url.path == '/quad':
                        self._send(gui._multi_page(4, 'Quad').encode(), 'text/html')
                    elif url.path == '/info':
                        self._send(gui._info_page().encode(), 'text/html')
                    elif url.path == '/log':
                        self._send(_LOG_PAGE.format(title=gui.app.name).encode(), 'text/html')
                    elif url.path == '/plot':
                        name = query.get('field', [gui.app.field_names[0]])[0]
                        self._send(gui._render_field_png(name), 'image/png')
                    elif url.path == '/curves':
                        self._send(gui._render_curves_png(), 'image/png')
                    elif url.path.startswith('/api/'):
                        result = gui._handle_api(url.path[len('/api/'):], query)
                        self._send(json.dumps(result).encode(), 'application/json')
                    else:
                        self._send(b'not found', 'text/plain', 404)
                except Exception as e:  # pragma: no cover — defensive server loop
                    self._send(json.dumps({'error': str(e)}).encode(), 'application/json', 500)

            do_POST = do_GET
        return Handler

    def show(self, block: bool = True, caller_is_main: bool = True):
        assert self.app is not None, "call setup(model) first"
        self._server = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        self.port = self._server.server_address[1]  # resolves port 0 → actual
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        print(f"phiflow-tpu-torch web GUI at http://{self.host}:{self.port}")
        if block:  # pragma: no cover
            try:
                self._thread.join()
            except KeyboardInterrupt:
                self.close()

    def close(self):
        if self._play is not None:
            self._play.pause()
            self._play = None
        if self._server is not None:
            self._server.shutdown()
            self._server = None


def web_view(model: VisModel, port: int = 8050, block: bool = False) -> WebGui:
    """One-call web UI over a VisModel / Viewer."""
    gui = WebGui(port=port)
    gui.setup(model)
    gui.show(block=block)
    return gui
