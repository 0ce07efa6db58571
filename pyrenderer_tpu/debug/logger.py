"""Ray-path debug logging — the wavefront generalization of the reference's
RayLogger (reference debug/ray_logger.py:1-15 accumulates line segments for
open3d; SURVEY §5.5 calls for "a debug mode that records per-bounce hit
records — straight generalization of RayLogger").

`log_paths` records, for a chosen set of pixels, every bounce's hit point,
normal, outgoing direction, hit face, visibility result, and running
throughput/radiance. Export as structured NumPy (.npz) or as an ASCII PLY
line-set viewable in any mesh tool (MeshLab/Blender) — replacing the
reference's blocking open3d window (reference core/scene.py:81
visualize_o3d).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from pyrenderer_tpu.config import RenderConfig
from pyrenderer_tpu.core.camera import generate_rays
from pyrenderer_tpu.core.integrator import TraceTables, trace_reference
from pyrenderer_tpu.scene.types import Camera, Scene


@dataclasses.dataclass
class RayPathLog:
    """Arrays indexed [bounce, ray]."""

    origin: np.ndarray       # (N, 3) primary ray origins
    first_dir: np.ndarray    # (N, 3)
    hit_point: np.ndarray    # (B, N, 3)
    normal: np.ndarray       # (B, N, 3)
    wi: np.ndarray           # (B, N, 3)
    t: np.ndarray            # (B, N)
    tri: np.ndarray          # (B, N)
    hit: np.ndarray          # (B, N) bool — closest-hit succeeded this bounce
    alive: np.ndarray        # (B, N) bool — path continued after this bounce
    beta: np.ndarray         # (B, N, 3)
    radiance: np.ndarray     # (B, N, 3) running estimate
    nee_visible: np.ndarray  # (B, N) bool
    light_point: np.ndarray  # (B, N, 3) sampled NEE light points

    @property
    def n_bounces(self) -> int:
        return self.hit_point.shape[0]

    def segments(self):
        """Line segments [(a, b, kind)] — kind 'path' or 'shadow'."""
        segs = []
        n = self.origin.shape[0]
        for r in range(n):
            prev = self.origin[r]
            for b in range(self.n_bounces):
                if not self.hit[b, r]:
                    break
                p = self.hit_point[b, r]
                segs.append((prev, p, "path"))
                if self.nee_visible[b, r]:
                    segs.append((p, self.light_point[b, r], "shadow"))
                prev = p
                if not self.alive[b, r]:
                    break
        return segs

    def save(self, path: str) -> None:
        np.savez(path, **dataclasses.asdict(self))

    def write_html(self, path: str, scene=None, max_wire_edges: int = 4000
                   ) -> None:
        """Self-contained interactive 3D viewer (single HTML file, no
        network, no dependencies — a vanilla-canvas orbit camera), the
        headless stand-in for the reference's blocking open3d windows
        (reference core/scene.py:81-91 visualize_o3d, debug/run.py): ray
        paths as white polylines from red origins, NEE shadow rays
        yellow, and (when `scene` is given) the mesh wireframe in blue,
        subsampled to `max_wire_edges` unique edges for big scenes."""
        import json

        def pt(a):
            return [round(float(x), 5) for x in a]

        paths = []
        shadows = []
        n = self.origin.shape[0]
        for r in range(n):
            pts = [pt(self.origin[r])]
            for b in range(self.n_bounces):
                if not self.hit[b, r]:
                    break
                p = self.hit_point[b, r]
                pts.append(pt(p))
                if self.nee_visible[b, r]:
                    shadows.append([pt(p), pt(self.light_point[b, r])])
                if not self.alive[b, r]:
                    break
            if len(pts) > 1:
                paths.append(pts)

        wire = []
        all_pts = [self.origin.reshape(-1, 3)]
        if scene is not None:
            v = np.asarray(scene.vertices, np.float64)
            f = np.asarray(scene.faces)
            edges = np.concatenate(
                [f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0
            )
            edges = np.unique(np.sort(edges, axis=1), axis=0)
            if edges.shape[0] > max_wire_edges:
                step = edges.shape[0] // max_wire_edges
                edges = edges[::step]
            wire = [[pt(v[a]), pt(v[b])] for a, b in edges]
            all_pts.append(v)
        if paths:
            all_pts.append(
                np.asarray([p for pts in paths for p in pts], np.float64)
            )
        pts = np.concatenate(all_pts, axis=0)
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        center = pt(0.5 * (lo + hi))
        radius = float(max(np.linalg.norm(hi - lo) * 0.5, 1e-6))

        data = json.dumps({
            "paths": paths, "shadow": shadows, "wire": wire,
            "center": center, "radius": radius,
        })
        counts = (f"{len(paths)} paths · {len(shadows)} shadow rays · "
                  f"{len(wire)} wire edges")
        with open(path, "w") as fo:
            fo.write(_HTML_TEMPLATE.format(data=data, counts=counts))

    def write_ply(self, path: str) -> None:
        """ASCII PLY line set: path segments white, shadow rays yellow."""
        segs = self.segments()
        verts = []
        edges = []
        colors = {"path": (255, 255, 255), "shadow": (255, 220, 40)}
        for a, b, kind in segs:
            i = len(verts)
            c = colors[kind]
            verts.append((a, c))
            verts.append((b, c))
            edges.append((i, i + 1))
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {len(verts)}\n")
            f.write("property float x\nproperty float y\nproperty float z\n")
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
            f.write(f"element edge {len(edges)}\n")
            f.write("property int vertex1\nproperty int vertex2\nend_header\n")
            for (v, c) in verts:
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
            for a, b in edges:
                f.write(f"{a} {b}\n")


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>pyrenderer_tpu ray paths</title>
<style>
 body {{ margin: 0; background: #101014; color: #ddd;
        font: 12px monospace; overflow: hidden; }}
 #hud {{ position: fixed; top: 8px; left: 10px; user-select: none; }}
 canvas {{ display: block; }}
</style></head><body>
<div id="hud">drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan<br>
{counts}</div>
<canvas id="c"></canvas>
<script>
const DATA = {data};
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
let yaw = 0.6, pitch = 0.4, dist = DATA.radius * 2.8;
let cx = DATA.center[0], cy = DATA.center[1], cz = DATA.center[2];
let panx = 0, pany = 0;
function resize() {{ cv.width = innerWidth; cv.height = innerHeight; draw(); }}
addEventListener("resize", resize);
let drag = null;
cv.addEventListener("mousedown", e => drag = [e.clientX, e.clientY, e.shiftKey]);
addEventListener("mouseup", () => drag = null);
addEventListener("mousemove", e => {{
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {{ panx += dx; pany += dy; }}
  else {{ yaw += dx * 0.008; pitch += dy * 0.008;
          pitch = Math.max(-1.55, Math.min(1.55, pitch)); }}
  drag = [e.clientX, e.clientY, drag[2]];
  draw();
}});
cv.addEventListener("wheel", e => {{
  dist *= Math.exp(e.deltaY * 0.001); draw(); e.preventDefault();
}}, {{passive: false}});
function project(p) {{
  const sy = Math.sin(yaw), cyw = Math.cos(yaw);
  const sp = Math.sin(pitch), cp = Math.cos(pitch);
  let x = p[0] - cx, y = p[1] - cy, z = p[2] - cz;
  let x1 = cyw * x + sy * z, z1 = -sy * x + cyw * z;
  let y1 = cp * y - sp * z1, z2 = sp * y + cp * z1;
  const d = z2 + dist;
  if (d <= 1e-6) return null;
  const f = 1.2 * Math.min(cv.width, cv.height) / d;
  return [cv.width / 2 + panx + x1 * f, cv.height / 2 + pany - y1 * f];
}}
function polyline(pts, style, width) {{
  ctx.strokeStyle = style; ctx.lineWidth = width;
  ctx.beginPath();
  let pen = false;
  for (const p of pts) {{
    const q = p && project(p);
    if (!q) {{ pen = false; continue; }}
    if (pen) ctx.lineTo(q[0], q[1]); else ctx.moveTo(q[0], q[1]);
    pen = true;
  }}
  ctx.stroke();
}}
function draw() {{
  ctx.clearRect(0, 0, cv.width, cv.height);
  ctx.globalAlpha = 0.25;
  for (const e of DATA.wire) polyline([e[0], e[1]], "#5f87af", 1);
  ctx.globalAlpha = 0.9;
  for (const s of DATA.shadow) polyline([s[0], s[1]], "#e8c840", 1);
  for (const p of DATA.paths) polyline(p, "#f0f0f0", 1.4);
  ctx.globalAlpha = 1.0;
  ctx.fillStyle = "#ff6060";
  for (const p of DATA.paths) {{
    const q = p.length && project(p[0]);
    if (q) {{ ctx.beginPath(); ctx.arc(q[0], q[1], 2.5, 0, 7); ctx.fill(); }}
  }}
}}
resize();
</script></body></html>
"""


def log_paths(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    pixel_x,
    pixel_y,
    sample_id: int = 0,
    backend: str = "auto",
) -> RayPathLog:
    """Trace the given pixels once, recording every bounce."""
    scene = jax.tree.map(jnp.asarray, scene)
    px = jnp.asarray(pixel_x, jnp.int32)
    py = jnp.asarray(pixel_y, jnp.int32)
    w, _ = camera.resolution
    pixel_id = (py * w + px).astype(jnp.uint32)
    sample = jnp.full_like(pixel_id, sample_id)
    ro, rd = generate_rays(camera, px, py, sample, cfg.seed)
    tables = TraceTables(scene, cfg.replace(estimator="reference"), backend)
    _, ys = trace_reference(
        scene, cfg, ro, rd, pixel_id, sample, cfg.seed,
        tables=tables, collect_paths=True,
    )
    host = {k: np.asarray(v) for k, v in ys.items()}
    return RayPathLog(
        origin=np.asarray(ro),
        first_dir=np.asarray(rd),
        **host,
    )
