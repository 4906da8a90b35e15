"""Visualization: offline map snapshots and a self-contained interactive
point-cloud viewer.

Mirrors ``mast3r_slam_tpu/viz.py``: the world point cloud, keyframe frusta,
trajectory and graph edges rendered as a PNG snapshot from any viewpoint
(``render_snapshot``, a z-buffered point splat in numpy) and as a
single-file HTML viewer with an embedded WebGL point cloud
(``export_html_viewer``, no network needed).  The host-numpy functions
(``np_sim3_Rst``, ``extract_kf_grid``, ``grid_stride``,
``compose_world_grids``, the frusta) are JAX's, line for line, so they give
its bits on the same arrays.  The arena's rows reach the host in one
batched copy (``host_copies``); the PNG is written with ``zlib`` and the
frusta drawn in numpy, so nothing here needs ``cv2``.
"""

from __future__ import annotations

import base64
import pathlib
import struct
import zlib

import numpy as np
import torch

from .frame import KeyframeArena
from .ops import lie_sim3 as sim3


def host_copies(tensors):
    """Host numpy copies of ``tensors``, which later in-place writes to them
    do not change.  On the card each is copied into pinned memory without
    blocking and the current stream is synchronised once, so the copies
    follow every write queued before them on that stream."""
    if tensors[0].device.type != "cuda":
        return [t.detach().clone().numpy() for t in tensors]
    out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
           for t in tensors]
    for o, t in zip(out, tensors):
        o.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [o.numpy() for o in out]


@torch.no_grad()
def _world_cloud(arena: KeyframeArena, conf_threshold: float = 1.5,
                 max_points: int = 400_000):
    """World points and colours of the confident pixels of every keyframe
    (viz.py:29): one batched Sim(3) action on the arena's device and one
    copy to the host; the confidence mask and the seeded subsample on the
    host, as in JAX, so the same points are kept in the same order."""
    n = int(arena.n_size)
    if n == 0:
        return np.zeros((0, 3)), np.zeros((0, 3))
    Xw = sim3.act(arena.T_WC[:n, None], arena.X[:n])
    Xw, C, Nc, uimg = host_copies([Xw, arena.C[:n, :, 0], arena.N[:n],
                                   arena.uimg[:n]])
    Nc = np.maximum(Nc, 1)
    uimg = uimg.astype(np.float32) / 255.0
    Xw_all, col_all = [], []
    for i in range(n):
        conf = C[i] / Nc[i]
        valid = conf > conf_threshold
        Xw_all.append(Xw[i][valid])
        col_all.append(uimg[i].reshape(-1, 3)[valid])
    pts = np.concatenate(Xw_all)
    cols = np.concatenate(col_all)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(
            len(pts), max_points, replace=False
        )
        pts, cols = pts[sel], cols[sel]
    return pts, cols


def np_sim3_Rst(T):
    """Host-side Sim(3) decomposition: T = [t(3), q(xyzw), s] (the
    ops/lie_sim3 embedding) -> (R (3,3), s, t (3,)) in numpy (viz.py:58)."""
    T = np.asarray(T, np.float64)
    t = T[:3]
    x, y, z, w = T[3:7] / (np.linalg.norm(T[3:7]) + 1e-30)
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    return R, float(T[7]), t


def extract_kf_grid(Xc_flat, C_flat, N_count, uimg_u8, h, w, stride,
                    conf_threshold):
    """CAMERA-FRAME grid extraction for ONE keyframe (viz.py:73): the
    subsampled pointmap grid with per-point normals (central differences)
    and 0-based local triangle indices with depth-discontinuity culling.
    Camera-frame grids are the unit of the viewer's per-keyframe cache:
    a pointmap changes only when its fusion count bumps, while the poses
    change every BA round.

    Returns (pts_c (nv,3) f32, cols (nv,3) f32 [0,1], nrm_c (nv,3) f32,
    tris_local (t,3) u32)."""
    Xc = np.asarray(Xc_flat).reshape(h, w, 3)[::stride, ::stride]
    conf = (np.asarray(C_flat)[:, 0] / max(int(N_count), 1)).reshape(
        h, w)[::stride, ::stride]
    col = (np.asarray(uimg_u8).astype(np.float32) / 255.0)[::stride,
                                                           ::stride]
    valid = conf > conf_threshold
    gh, gw = Xc.shape[:2]

    # normals from grid central differences
    du = np.gradient(Xc, axis=1)
    dv = np.gradient(Xc, axis=0)
    nrm = np.cross(du.reshape(-1, 3), dv.reshape(-1, 3))
    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = (nrm / np.maximum(ln, 1e-12)).reshape(gh, gw, 3)

    idx_map = np.full((gh, gw), -1, np.int64)
    nv = int(valid.sum())
    idx_map[valid] = np.arange(nv)
    pts_c = Xc[valid].astype(np.float32)
    cols = col[valid].astype(np.float32)
    nrm_c = nrm[valid].astype(np.float32)

    # triangles with depth-discontinuity culling: drop quads whose 3D edges
    # exceed ~8x the median grid spacing of this keyframe
    a = idx_map[:-1, :-1]
    b = idx_map[:-1, 1:]
    c = idx_map[1:, :-1]
    d = idx_map[1:, 1:]
    eh = np.linalg.norm(Xc[:, 1:] - Xc[:, :-1], axis=-1)
    evd = np.linalg.norm(Xc[1:] - Xc[:-1], axis=-1)
    med = np.median(np.concatenate(
        [eh.reshape(-1), evd.reshape(-1)])) + 1e-12
    tau = 8.0 * med
    ok_e = ((eh[:-1] < tau) & (evd[:, :-1] < tau)
            & (eh[1:] < tau) & (evd[:, 1:] < tau))
    quad_ok = (a >= 0) & (b >= 0) & (c >= 0) & (d >= 0) & ok_e
    tris = np.zeros((0, 3), np.uint32)
    if quad_ok.any():
        aa, bb, cc, dd = (x[quad_ok] for x in (a, b, c, d))
        tris = np.concatenate([
            np.stack([aa, bb, cc], -1),
            np.stack([bb, dd, cc], -1),
        ]).astype(np.uint32)
    return pts_c, cols, nrm_c, tris


def grid_stride(n_kf: int, h: int, w: int, max_points: int) -> int:
    """(viz.py:136)"""
    return max(1, int(np.ceil(np.sqrt(max(n_kf * h * w / max_points, 1)))))


def compose_world_grids(entries, T_rows):
    """Assemble (pts, cols, nrms, tris) in WORLD coordinates from cached
    camera-frame grids + current poses (viz.py:140).  entries: list of
    (pts_c, cols, nrm_c, tris_local); T_rows: matching (n, 8) poses."""
    pts_all, col_all, nrm_all, tri_all = [], [], [], []
    base = 0
    for (pts_c, cols, nrm_c, tris), Ti in zip(entries, T_rows):
        R, s, t = np_sim3_Rst(Ti)
        Rf = R.astype(np.float32)
        pts_all.append(pts_c @ (s * Rf).T + t.astype(np.float32))
        col_all.append(cols)
        # normals rotate only (uniform scale preserves direction)
        nrm_all.append(nrm_c @ Rf.T)
        if len(tris):
            tri_all.append(tris + np.uint32(base))
        base += len(pts_c)
    pts = np.concatenate(pts_all) if pts_all else np.zeros((0, 3))
    cols = np.concatenate(col_all) if col_all else np.zeros((0, 3))
    nrms = np.concatenate(nrm_all) if nrm_all else np.zeros((0, 3))
    tris = np.concatenate(tri_all) if tri_all else \
        np.zeros((0, 3), np.uint32)
    return (pts.astype(np.float32), cols.astype(np.float32),
            nrms.astype(np.float32), tris)


@torch.no_grad()
def _world_cloud_grid(arena: KeyframeArena, conf_threshold: float = 1.5,
                      max_points: int = 400_000):
    """Grid-aware map extraction for surfel / triangle-mesh rendering
    (viz.py:165): the cache-free composition of extract_kf_grid +
    compose_world_grids over all keyframes, from one copy of their rows.
    The live viewer keeps a per-keyframe cache instead
    (``viz_server.LiveViewer.publish``).

    Returns (pts (M,3) f32, cols (M,3) f32 in [0,1], normals (M,3) f32,
    tris (T,3) u32)."""
    n = int(arena.n_size)
    if n == 0:
        return (np.zeros((0, 3), np.float32),) * 3 + (
            np.zeros((0, 3), np.uint32),)
    h, w = arena.img_hw
    stride = grid_stride(n, h, w, max_points)
    T, X, C, Nc, uimg = host_copies([arena.T_WC[:n], arena.X[:n],
                                     arena.C[:n], arena.N[:n],
                                     arena.uimg[:n]])
    entries = [
        extract_kf_grid(X[i], C[i], Nc[i], uimg[i], h, w, stride,
                        conf_threshold)
        for i in range(n)
    ]
    return compose_world_grids(entries, T)


def frusta_segments(T, scale: float = 0.1):
    """Line segments (m, 2, 3) of the camera frusta of the host poses
    ``T`` (n, 8) in world coordinates (viz.py:193-210)."""
    corners = np.array(
        [[0, 0, 0], [-1, -0.75, 1.5], [1, -0.75, 1.5],
         [1, 0.75, 1.5], [-1, 0.75, 1.5]]
    ) * scale
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    segs = []
    for i in range(len(T)):
        R, s, t = np_sim3_Rst(T[i])
        cw = corners @ (s * R).T + t
        for a, b in edges:
            segs.append((cw[a], cw[b]))
    return np.asarray(segs)  # (m, 2, 3)


def _frusta(arena: KeyframeArena, scale: float = 0.1):
    """Keyframe camera frusta in world coordinates (viz.py:193), from one
    copy of the pose table."""
    (T,) = host_copies([arena.T_WC[:int(arena.n_size)]])
    return frusta_segments(T, scale)


def png_bytes(img) -> bytes:
    """An (h, w, 3) uint8 RGB image as PNG file bytes: 8-bit truecolour,
    every row with filter 0, one ``zlib`` stream (level 1, the fast end:
    the viewer encodes a frame every third frame)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = img.reshape(h, 3 * w)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + chunk(b"IEND", b""))


def draw_line(img, p0, p1, color):
    """A one-pixel line from ``p0`` to ``p1`` ((x, y) pixels, either end
    may lie outside) into ``img`` (h, w, 3) in place: one pixel per step
    along the longer axis, the other coordinate rounded half to even, the
    pixels outside the image dropped.  It stands in for ``cv2.line``'s
    8-connected line and may differ from it by a pixel where the exact
    line passes midway between two."""
    h, w = img.shape[:2]
    (x0, y0), (x1, y1) = p0, p1
    steps = max(abs(int(x1) - int(x0)), abs(int(y1) - int(y0)))
    t = np.arange(steps + 1) / max(steps, 1)
    x = np.round(x0 + t * (x1 - x0)).astype(np.int64)
    y = np.round(y0 + t * (y1 - y0)).astype(np.int64)
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    img[y[inside], x[inside]] = color


def snapshot_image(arena: KeyframeArena, conf_threshold: float = 1.5,
                   image_size: int = 960, elev: float = 25.0,
                   azim: float = -60.0):
    """The (image_size, image_size, 3) uint8 RGB image of
    ``render_snapshot`` (viz.py:214-265)."""
    pts, cols = _world_cloud(arena, conf_threshold)
    segs = _frusta(arena)
    if len(pts) == 0:
        return np.zeros((image_size, image_size, 3), np.uint8)

    # view rotation
    el, az = np.radians(elev), np.radians(azim)
    Rz = np.array([[np.cos(az), -np.sin(az), 0],
                   [np.sin(az), np.cos(az), 0], [0, 0, 1]])
    Rx = np.array([[1, 0, 0], [0, np.cos(el), -np.sin(el)],
                   [0, np.sin(el), np.cos(el)]])
    R = Rx @ Rz
    P = pts @ R.T
    center = P.mean(0)
    span = np.percentile(np.abs(P - center), 98) * 2.2 + 1e-6
    uv = ((P[:, :2] - center[:2]) / span + 0.5) * (image_size - 1)
    z = P[:, 2]

    img = np.full((image_size, image_size, 3), 16, np.uint8)
    ui = np.clip(uv[:, 0].astype(int), 0, image_size - 1)
    vi = np.clip((image_size - 1 - uv[:, 1]).astype(int), 0, image_size - 1)
    order = np.argsort(-z)  # far to near
    img[vi[order], ui[order]] = (cols[order] * 255).astype(np.uint8)

    for a, b in segs:
        pa = ((a @ R.T)[:2] - center[:2]) / span + 0.5
        pb = ((b @ R.T)[:2] - center[:2]) / span + 0.5
        pa = (pa * (image_size - 1)).astype(int)
        pb = (pb * (image_size - 1)).astype(int)
        draw_line(img, (pa[0], image_size - 1 - pa[1]),
                  (pb[0], image_size - 1 - pb[1]), (0, 255, 255))
    return img


def render_snapshot(arena: KeyframeArena, out_png,
                    conf_threshold: float = 1.5,
                    image_size: int = 960, elev: float = 25.0,
                    azim: float = -60.0):
    """Z-buffered orthographic point splat of the map + frusta to a PNG
    (viz.py:214)."""
    pathlib.Path(out_png).write_bytes(png_bytes(snapshot_image(
        arena, conf_threshold, image_size, elev, azim)))


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>SLAM map</title><style>
body{margin:0;background:#111;color:#ddd;font-family:monospace}
canvas{display:block}#hud{position:fixed;top:8px;left:8px}
</style></head><body>
<div id="hud">drag: orbit | wheel: zoom | %NPTS% points, %NKF% keyframes</div>
<canvas id="c"></canvas>
<script>
const DATA = "%DATA%";
const raw = Uint8Array.from(atob(DATA), ch => ch.charCodeAt(0));
const f32 = new Float32Array(raw.buffer, 0, %NPTS% * 3);
const cols = new Uint8Array(raw.buffer, %NPTS% * 12, %NPTS% * 3);
const canvas = document.getElementById('c');
const gl = canvas.getContext('webgl');
const vs = `attribute vec3 p;attribute vec3 c;uniform mat4 mvp;
varying vec3 vc;void main(){gl_Position=mvp*vec4(p,1.0);
gl_PointSize=1.5;vc=c;}`;
const fs = `precision mediump float;varying vec3 vc;
void main(){gl_FragColor=vec4(vc,1.0);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
gl.compileShader(o);return o;}
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER, vs));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER, fs));
gl.linkProgram(prog); gl.useProgram(prog);
const pbuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, pbuf);
gl.bufferData(gl.ARRAY_BUFFER, f32, gl.STATIC_DRAW);
const pl = gl.getAttribLocation(prog, 'p');
gl.enableVertexAttribArray(pl);
gl.vertexAttribPointer(pl, 3, gl.FLOAT, false, 0, 0);
const cbuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, cbuf);
gl.bufferData(gl.ARRAY_BUFFER, cols, gl.STATIC_DRAW);
const cl = gl.getAttribLocation(prog, 'c');
gl.enableVertexAttribArray(cl);
gl.vertexAttribPointer(cl, 3, gl.UNSIGNED_BYTE, true, 0, 0);
const mvpLoc = gl.getUniformLocation(prog, 'mvp');
let rx=0.5, ry=-0.8, dist=%SPAN%;
const ctr = [%CX%, %CY%, %CZ%];
function mat(){
 const cx=Math.cos(rx),sx=Math.sin(rx),cy=Math.cos(ry),sy=Math.sin(ry);
 const a=canvas.width/canvas.height, f=1.5, n=0.01*dist, fa=100*dist;
 // rotate around center, translate back by dist, perspective
 const R=[[cy,0,sy],[sx*sy,cx,-sx*cy],[-cx*sy,sx,cx*cy]];
 const m=new Float32Array(16);
 for(let i=0;i<3;i++){m[i*4]=R[0][i];m[i*4+1]=R[1][i];m[i*4+2]=R[2][i];}
 let t=[0,0,0];
 for(let i=0;i<3;i++){t[i]=-(R[i][0]*ctr[0]+R[i][1]*ctr[1]+R[i][2]*ctr[2]);}
 t[2]-=dist;
 const P=[f/a,0,0,0, 0,f,0,0, 0,0,(fa+n)/(n-fa),-1, 0,0,2*fa*n/(n-fa),0];
 const out=new Float32Array(16);
 for(let r2=0;r2<4;r2++)for(let c2=0;c2<4;c2++){let s=0;
  for(let k=0;k<4;k++){
   const mv=(k<3)?((r2<3)?m[k*4+r2]:0):((r2<3)?t[r2]:1);
   s+=P[c2*4+k]*mv;}
  out[c2*4+r2]=s;}
 return out;}
function draw(){
 canvas.width=innerWidth;canvas.height=innerHeight;
 gl.viewport(0,0,canvas.width,canvas.height);
 gl.clearColor(0.06,0.06,0.08,1);gl.clear(gl.COLOR_BUFFER_BIT);
 gl.uniformMatrix4fv(mvpLoc,false,mat());
 gl.drawArrays(gl.POINTS,0,%NPTS%);
 requestAnimationFrame(draw);}
let drag=false,lx=0,ly=0;
canvas.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
 ry+=(e.clientX-lx)*0.005;rx+=(e.clientY-ly)*0.005;
 lx=e.clientX;ly=e.clientY;};
canvas.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
draw();
</script></body></html>
"""


def export_html_viewer(arena: KeyframeArena, out_html,
                       conf_threshold: float = 1.5,
                       max_points: int = 300_000):
    """Write a single-file interactive WebGL viewer of the map, which works
    fully offline (viz.py:336)."""
    pts, cols = _world_cloud(arena, conf_threshold, max_points)
    pts32 = pts.astype(np.float32)
    cols8 = (np.clip(cols, 0, 1) * 255).astype(np.uint8)
    blob = pts32.tobytes() + cols8.tobytes()
    center = pts32.mean(0) if len(pts32) else np.zeros(3)
    span = (np.percentile(np.linalg.norm(pts32 - center, axis=1), 95) * 2.5
            if len(pts32) else 1.0)
    html = (_HTML_TEMPLATE
            .replace("%DATA%", base64.b64encode(blob).decode())
            .replace("%NPTS%", str(len(pts32)))
            .replace("%NKF%", str(int(arena.n_size)))
            .replace("%CX%", f"{center[0]:.4f}")
            .replace("%CY%", f"{center[1]:.4f}")
            .replace("%CZ%", f"{center[2]:.4f}")
            .replace("%SPAN%", f"{span:.4f}"))
    pathlib.Path(out_html).write_text(html)
