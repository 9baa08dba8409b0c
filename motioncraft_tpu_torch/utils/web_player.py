"""A self-contained browser player for generated motion (port of
motioncraft_tpu/utils/web_player.py; the same HTML byte for byte).

One dependency-free HTML file with the FK joint trajectories embedded as
JSON and a vanilla-JS <canvas> renderer: open it in any browser, no server,
no network.  Play / pause, a scrub bar, an fps box, an auto-fit orthographic
projection with a slow turntable yaw, bones from the parent table.

Written by ``tools/torch_visualize.py --web``, ``torch_m2d_visualize.py
--web`` and ``torch_s2g_visualize.py --web``; callable directly:

    from motioncraft_tpu_torch.utils.web_player import export_web_player
    export_web_player(joints, SMPLX_PARENTS, "sample.html", fps=30)
"""

import json

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>__TITLE__</title>
<style>
  body { margin: 0; background: #111; color: #ddd;
         font: 13px system-ui, sans-serif; }
  #bar { padding: 8px 12px; display: flex; gap: 10px; align-items: center; }
  canvas { display: block; margin: 0 auto; background: #181818; }
  input[type=range] { flex: 1; }
  button { background: #333; color: #ddd; border: 1px solid #555;
           padding: 4px 14px; cursor: pointer; }
</style>
</head>
<body>
<div id="bar">
  <button id="play">pause</button>
  <input id="seek" type="range" min="0" value="0" step="1">
  <span id="label"></span>
  <label>fps <input id="fps" type="number" min="1" max="120" step="1"
                    style="width:4em"></label>
</div>
<canvas id="cv" width="720" height="720"></canvas>
<script id="motion-data" type="application/json">__DATA__</script>
<script>
"use strict";
const D = JSON.parse(document.getElementById("motion-data").textContent);
const J = D.joints, P = D.parents, T = J.length, NJ = P.length;
const cv = document.getElementById("cv"), ctx = cv.getContext("2d");
const seek = document.getElementById("seek"), label = document.getElementById("label");
const playBtn = document.getElementById("play"), fpsBox = document.getElementById("fps");
seek.max = T - 1; fpsBox.value = D.fps;
// auto-fit bounds over the whole clip
let mn = [1e9, 1e9, 1e9], mx = [-1e9, -1e9, -1e9];
for (const fr of J) for (const p of fr) for (let a = 0; a < 3; a++) {
  mn[a] = Math.min(mn[a], p[a]); mx[a] = Math.max(mx[a], p[a]);
}
const ctr = [0, 1, 2].map(a => (mn[a] + mx[a]) / 2);
const span = Math.max(mx[0] - mn[0], mx[1] - mn[1], mx[2] - mn[2], 1e-6);
const scale = 0.8 * Math.min(cv.width, cv.height) / span;
let frame = 0, playing = true, yaw = 0;
function project(p) {
  // y-up data: orthographic, turntable yaw about the vertical axis
  const x = p[0] - ctr[0], y = p[1] - ctr[1], z = p[2] - ctr[2];
  const c = Math.cos(yaw), s = Math.sin(yaw);
  const rx = c * x + s * z;
  return [cv.width / 2 + rx * scale, cv.height / 2 - y * scale];
}
function draw() {
  ctx.clearRect(0, 0, cv.width, cv.height);
  const fr = J[frame];
  ctx.strokeStyle = "#6fb3ff"; ctx.lineWidth = 2; ctx.beginPath();
  for (let i = 0; i < NJ; i++) {
    if (P[i] < 0) continue;
    const a = project(fr[i]), b = project(fr[P[i]]);
    ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]);
  }
  ctx.stroke();
  ctx.fillStyle = "#ffcf6f";
  for (let i = 0; i < NJ; i++) {
    const a = project(fr[i]);
    ctx.fillRect(a[0] - 1.5, a[1] - 1.5, 3, 3);
  }
  seek.value = frame;
  label.textContent = "frame " + frame + " / " + (T - 1);
}
let last = 0;
function tick(ts) {
  const fps = Math.max(1, +fpsBox.value || D.fps);
  if (playing && ts - last >= 1000 / fps) {
    frame = (frame + 1) % T; yaw += 0.004; last = ts;
  }
  draw();
  requestAnimationFrame(tick);
}
playBtn.onclick = () => { playing = !playing; playBtn.textContent = playing ? "pause" : "play"; };
seek.oninput = () => { frame = +seek.value; playing = false; playBtn.textContent = "play"; };
requestAnimationFrame(tick);
</script>
</body>
</html>
"""


def export_web_player(joints, parents, path: str, fps: int = 30,
                      title: str = "motion", max_frames: int = 2000) -> str:
    """Write a standalone HTML player for `joints` [T, J, 3] with skeleton
    `parents` [J] (-1 = root).  Trajectories are embedded as float32-rounded
    JSON; clips longer than `max_frames` are uniformly subsampled (with fps
    rescaled) to keep the file size sane.  Returns `path`."""
    joints = np.asarray(joints, np.float32)
    if joints.ndim != 3 or joints.shape[-1] != 3:
        raise ValueError(f"joints must be [T, J, 3], got {joints.shape}")
    parents = [int(p) for p in np.asarray(parents).ravel()]
    if len(parents) != joints.shape[1]:
        raise ValueError(f"parents has {len(parents)} entries for "
                         f"{joints.shape[1]} joints")
    if len(joints) > max_frames:
        idx = np.linspace(0, len(joints) - 1, max_frames).round().astype(int)
        fps = max(1, int(round(fps * max_frames / len(joints))))
        joints = joints[idx]
    data = {
        "fps": int(fps),
        "parents": parents,
        "joints": [[[round(float(v), 4) for v in p] for p in fr]
                   for fr in joints],
    }
    html = (_TEMPLATE
            .replace("__TITLE__", title)
            .replace("__DATA__", json.dumps(data, separators=(",", ":"))))
    with open(path, "w") as f:
        f.write(html)
    return path
