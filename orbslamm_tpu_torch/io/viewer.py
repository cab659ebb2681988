"""Live viewer: a background HTTP server over a running MultiMapper (port of
orbslamm_tpu/io/viewer.py).

The reference's Viewer is a Pangolin GL thread with menu toggles
(Viewer.cc:66-152: Follow Camera, Show Points, Localization Mode,
Multi-Mapping). A headless machine gets the same surface as a small
in-process HTTP server: it renders the largest live map on request
(``io/viz.draw_map``), serves a self-refreshing page and a JSON status,
and takes the runtime toggles as POST requests.

    viewer = LiveViewer(mm, port=8642).start()   # a daemon thread
    ... run the session, each step inside ``with viewer.span():`` ...
    viewer.stop()

Endpoints:
    GET  /          self-refreshing HTML dashboard
    GET  /map.png   the largest live map, rendered on request
    GET  /state     JSON: robots (state, map, frames), maps, merges
    POST /localization/<on|off>   System::ActivateLocalizationMode
    POST /multimapping/<on|off>   Tracking::InformMultiMapping

Every handler holds ``lock``, and ``driver.run_robots`` holds it around
each robot's span (``span()``), so a render or a toggle lands between
spans: never while a chunk is in flight, whose state the localization
toggle would read back (``_sync_from_ts``) from under it. ``span()`` first
lets the requests that wait for the lock through; without that the driver
would take the lock again at once and a request would wait for the run's
end. The map's tensors are read with one ``.cpu()`` a field
(``viz.map_arrays``).
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>orbslamm_tpu</title>
<meta http-equiv="refresh" content="2">
<style>body{background:#111;color:#ddd;font-family:monospace}</style>
</head><body>
<h3>orbslamm_tpu live viewer</h3>
<pre id="s">%s</pre>
<img src="/map.png" style="max-width:90%%">
</body></html>"""


class LiveViewer:
    """Background HTTP dashboard over a MultiMapper (or any object with
    ``robots``, ``live_maps()``, ``merges`` and ``set_multi_mapping``).
    ``port=0`` takes a free port; ``port`` holds the bound one after
    ``start``."""

    def __init__(self, mm, port: int = 8642, host: str = "127.0.0.1"):
        self.mm = mm
        self.port = port
        self.host = host
        self.lock = threading.RLock()
        self._waiting = 0  # requests waiting for the lock
        self._queue = threading.Condition()
        self._httpd = None
        self._thread = None

    @contextlib.contextmanager
    def span(self):
        """Held by the driver around one robot's span: the requests waiting
        for the lock go first, then the span holds it."""
        with self._queue:
            self._queue.wait_for(lambda: self._waiting == 0)
        with self.lock:
            yield

    @contextlib.contextmanager
    def _request(self):
        with self._queue:
            self._waiting += 1
        try:
            with self.lock:
                yield
        finally:
            with self._queue:
                self._waiting -= 1
                self._queue.notify_all()

    # -- renderings --------------------------------------------------------
    def _state_json(self) -> bytes:
        mm = self.mm
        out = {
            "robots": [
                {"name": t.name, "state": t.state.name,
                 "map_id": t.mapctx.map_id, "frames": len(t.frames)}
                for t in mm.robots
            ],
            "maps": [m.summary() for m in mm.live_maps()],
            "merges": list(mm.merges),
        }
        return json.dumps(out).encode()

    def _map_png(self) -> bytes:
        from orbslamm_tpu_torch.io import viz

        mm = self.mm
        maps = mm.live_maps()
        if not maps:
            return b""
        # the largest live map, with every robot's frames on it
        mc = max(maps, key=lambda m: m.n_kf)
        traj = [np.stack(pts) for t in mm.robots
                if (pts := [f.T_cw for f in t.frames
                            if f.state == "OK" and f.map_id == mc.map_id])]
        buf = io.BytesIO()
        viz.draw_map(mc.map, buf, trajectory=np.concatenate(traj) if traj else None,
                     title=f"map {mc.map_id} (live)")
        return buf.getvalue()

    def set_localization(self, on: bool) -> None:
        for t in self.mm.robots:
            t._sync_from_ts()
            t.localization_only = on

    # -- server ------------------------------------------------------------
    def start(self) -> "LiveViewer":
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    with viewer._request():
                        if self.path == "/map.png":
                            body, ctype = viewer._map_png(), "image/png"
                        elif self.path == "/state":
                            body, ctype = viewer._state_json(), "application/json"
                        else:
                            body = (_PAGE % viewer._state_json().decode()).encode()
                            ctype = "text/html"
                except Exception as e:  # a failed render answers, with its error
                    self._send(503, "text/plain", str(e).encode())
                    return
                self._send(200, ctype, body)

            def do_POST(self):
                on = self.path.endswith("/on")
                if self.path.startswith("/localization/"):
                    with viewer._request():
                        viewer.set_localization(on)
                elif self.path.startswith("/multimapping/"):
                    with viewer._request():
                        viewer.mm.set_multi_mapping(on)
                else:
                    self._send(404, "text/plain", b"unknown")
                    return
                self._send(200, "text/plain", b"ok")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join()
            self._httpd = self._thread = None
