"""Live web viewer — the Pangolin-viewer equivalent (E12).

The reference toggles a Pangolin GL window with the `use_pangolin` param
(`src/imu_mono_realsense.cpp:59,100`) showing the live
trajectory, map points, and current camera. A GL window makes no sense on a
headless accelerator host; the equivalent here is a zero-dependency HTTP
viewer: a
background thread serves a self-contained HTML canvas page that polls
`/state.json` (current pose, keyframe trail, subsampled map cloud,
tracking-state counters) and renders a top-down + side orthographic view.
Start it with `run_slam.py --viewer [PORT]` and open http://host:PORT/.

The state snapshot runs on the request thread. The System keeps the pose
and the trajectory on the host as numpy; the map lives in tensors on the
System's device, and a snapshot reads each of the three it needs (landmark
positions, their valid flags, the keyframe count) with one `.cpu()`.

Copied from `orb_slam3_ros2_tpu/runtime/viewer.py` (stdlib and numpy);
`snapshot()` is rewritten for the port's map tensors."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>tpu-slam live viewer</title><style>
body { background:#111; color:#ddd; font:13px monospace; margin:0; }
#bar { padding:6px 10px; background:#1b1b1b; }
#bar b { color:#7fd4ff; }
canvas { display:block; }
</style></head><body>
<div id="bar">tpu-slam &nbsp; state=<b id="st">-</b> &nbsp;
 keyframes=<b id="kf">0</b> &nbsp; landmarks=<b id="lm">0</b> &nbsp;
 frames=<b id="fr">0</b></div>
<canvas id="c"></canvas>
<script>
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
function fit() { cv.width = innerWidth; cv.height = innerHeight - 34; }
addEventListener('resize', fit); fit();
function proj(p, axes, box, view) {
  const [a, b] = axes;
  const sx = (p[a] - box.cx) * box.s + view.x + view.w / 2;
  const sy = (p[b] - box.cy) * box.s + view.y + view.h / 2;
  return [sx, sy];
}
function bbox(pts, axes, view) {
  const [a, b] = axes;
  let lo = [1e9, 1e9], hi = [-1e9, -1e9];
  for (const p of pts) {
    lo[0] = Math.min(lo[0], p[a]); hi[0] = Math.max(hi[0], p[a]);
    lo[1] = Math.min(lo[1], p[b]); hi[1] = Math.max(hi[1], p[b]);
  }
  const w = Math.max(hi[0] - lo[0], 1e-3), h = Math.max(hi[1] - lo[1], 1e-3);
  return { cx: (lo[0] + hi[0]) / 2, cy: (lo[1] + hi[1]) / 2,
           s: 0.9 * Math.min(view.w / w, view.h / h) };
}
function drawView(d, axes, view, label) {
  const all = d.points.concat(d.trajectory, [d.center]);
  if (!all.length) return;
  const box = bbox(all, axes, view);
  ctx.strokeStyle = '#333';
  ctx.strokeRect(view.x, view.y, view.w, view.h);
  ctx.fillStyle = '#666'; ctx.fillText(label, view.x + 6, view.y + 14);
  ctx.fillStyle = '#9f9';
  for (const p of d.points) {
    const [x, y] = proj(p, axes, box, view); ctx.fillRect(x, y, 2, 2);
  }
  ctx.strokeStyle = '#7fd4ff'; ctx.beginPath();
  d.trajectory.forEach((p, i) => {
    const [x, y] = proj(p, axes, box, view);
    i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
  });
  ctx.stroke();
  ctx.fillStyle = '#ff5577';
  const [cx2, cy2] = proj(d.center, axes, box, view);
  ctx.beginPath(); ctx.arc(cx2, cy2, 5, 0, 7); ctx.fill();
}
async function tick() {
  try {
    const d = await (await fetch('state.json')).json();
    document.getElementById('st').textContent = d.state;
    document.getElementById('kf').textContent = d.n_keyframes;
    document.getElementById('lm').textContent = d.n_landmarks;
    document.getElementById('fr').textContent = d.n_frames;
    ctx.fillStyle = '#111'; ctx.fillRect(0, 0, cv.width, cv.height);
    const w = cv.width / 2 - 12;
    drawView(d, [0, 2], {x: 8, y: 8, w: w, h: cv.height - 16}, 'top (x-z)');
    drawView(d, [0, 1], {x: cv.width / 2 + 4, y: 8, w: w,
                         h: cv.height - 16}, 'side (x-y)');
  } catch (e) {}
  setTimeout(tick, 500);
}
tick();
</script></body></html>"""


class LiveViewer:
    """Background HTTP viewer over a running System."""

    def __init__(self, system, port: int = 8400, max_points: int = 4000,
                 host: str = "127.0.0.1"):
        # loopback by default: the map/trajectory stream is unauthenticated,
        # so external exposure must be an explicit choice (host="0.0.0.0")
        self.system = system
        self.max_points = max_points
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    body = _PAGE.encode()
                    ctype = "text/html"
                elif self.path == "/state.json":
                    body = json.dumps(viewer.snapshot()).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def snapshot(self) -> dict:
        s = self.system
        T = np.asarray(s.Tcw)
        center = (-T[:3, :3].T @ T[:3, 3]).tolist()
        traj = [
            (-np.asarray(Ti)[:3, :3].T @ np.asarray(Ti)[:3, 3]).tolist()
            for _, Ti in s.trajectory[-600:]
        ]
        m = s.map
        valid = m.lm_valid.cpu().numpy()
        pts = m.lm_X.cpu().numpy()[valid]
        n_kf = int(m.n_kf)
        if len(pts) > self.max_points:
            pts = pts[:: len(pts) // self.max_points + 1]
        return {
            "state": s.get_tracking_state().name,
            "n_keyframes": n_kf,
            "n_landmarks": int(valid.sum()),
            "n_frames": int(s.n_frames),
            "center": center,
            "trajectory": traj,
            "points": np.round(pts, 4).tolist(),
        }

    def close(self):
        self.server.shutdown()
        self.server.server_close()
