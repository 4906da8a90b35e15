"""Live map viewer: an in-process HTTP server and a WebGL browser client.

Mirrors ``mast3r_slam_tpu/viz_server.py``: the live point-cloud / surfel /
mesh view of the keyframe map, camera frusta, factor-graph edge lines and
the control channel back into the frame loop (pause, single step and the
confidence threshold, ``WindowMsg``).  The page is served by a daemon
thread on localhost; the endpoints, the ``<6I`` header and blob layout of
``/cloud`` and the page are JAX's.

The arena is written in place by the frontend and by the backend thread,
so ``publish`` takes, under the system's lock, the keyframe count, the
per-row versions (``N_updates``) and the poses, and the rows whose version
changed since the last publish, each field in one gather and one copy to
the host; everything after those copies is host numpy outside the lock.

Usage:
    viewer = LiveViewer(port=8089)
    ...
    viewer.publish(system.arena, ii, jj, stats, lock=system._lock)
    msg = viewer.get_msg()       # pause / next / conf
"""

from __future__ import annotations

import contextlib
import json
import struct
import threading
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from . import viz

# the longest close() waits for the server thread to end
CLOSE_TIMEOUT_S = 5.0


@dataclass
class WindowMsg:
    """Control state of the viewer (viz_server.py:50)."""

    is_paused: bool = False
    next: int = 0                     # pending single-step count
    C_conf_threshold: float = 1.5


class LiveViewer:
    """(viz_server.py:59)  ``port`` 0 takes a free port; ``self.port`` is
    the one served.  ``rows_pulled`` and ``bytes_pulled`` count the
    keyframe rows and the bytes ``publish`` has copied to the host."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8089,
                 max_points: int = 400_000):
        self.max_points = max_points
        self._lock = threading.Lock()
        self._blob = b""
        self._meta = {"version": 0, "npts": 0, "nkf": 0, "nfr": 0,
                      "nedge": 0, "stats": {}}
        self._msg = WindowMsg()
        self._frame_png = b""
        self._frame_version = 0
        self._cache_key = None
        self._kf_cache = {}
        self.rows_pulled = 0
        self.bytes_pulled = 0

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif u.path == "/meta":
                    with viewer._lock:
                        body = json.dumps(viewer._meta).encode()
                    self._send(200, body, "application/json")
                elif u.path == "/cloud":
                    with viewer._lock:
                        body = viewer._blob
                    self._send(200, body, "application/octet-stream")
                elif u.path == "/frame":
                    with viewer._lock:
                        body = viewer._frame_png
                    if body:
                        self._send(200, body, "image/png")
                    else:
                        self._send(404, b"no frame", "text/plain")
                elif u.path == "/ctrl":
                    q = parse_qs(u.query)
                    with viewer._lock:
                        if "pause" in q:
                            viewer._msg.is_paused = q["pause"][0] == "1"
                        if "step" in q:
                            viewer._msg.next += 1
                        if "conf" in q:
                            viewer._msg.C_conf_threshold = float(
                                q["conf"][0]
                            )
                    self._send(200, b"ok", "text/plain")
                else:
                    self._send(404, b"not found", "text/plain")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="viz-server",
            daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------

    def get_msg(self) -> WindowMsg:
        """Current control state; `next` is consumed by the caller via
        consume_step() (viz_server.py:126)."""
        with self._lock:
            return WindowMsg(self._msg.is_paused, self._msg.next,
                             self._msg.C_conf_threshold)

    def consume_step(self):
        with self._lock:
            if self._msg.next > 0:
                self._msg.next -= 1

    def publish_frame(self, uimg):
        """The current frame for the page's corner preview, PNG-encoded
        (viz_server.py:138): host numpy and ``zlib`` only."""
        img = np.asarray(uimg)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        png = viz.png_bytes(img)
        with self._lock:
            self._frame_png = png
            self._frame_version += 1
            self._meta["frame_version"] = self._frame_version

    @torch.no_grad()
    def _pull(self, arena, lock, conf_threshold):
        """The host side of a publish, read under ``lock``: (n, poses (n,
        8)) with the cache brought up to the arena.  The versions
        and poses come first (one copy each, one synchronisation), then the
        rows whose ``N_updates`` differs from the cached one, each field in
        one ``index_select`` and one copy.  Returns n 0 for an empty
        arena."""
        with lock:
            n = int(arena.n_size)
            if n == 0:
                return 0, None
            h, w = arena.img_hw
            stride = viz.grid_stride(n, h, w, self.max_points)
            key = (stride, conf_threshold, h, w)
            if key != self._cache_key:
                self._cache_key = key
                self._kf_cache = {}
            vers, T = viz.host_copies([arena.N_updates[:n], arena.T_WC[:n]])
            dirty = [i for i in range(n)
                     if self._kf_cache.get(i, (None,))[0] != int(vers[i])]
            rows = []
            if dirty:
                idx = torch.tensor(dirty, device=arena.X.device)
                rows = viz.host_copies([arena.X.index_select(0, idx),
                                        arena.C.index_select(0, idx),
                                        arena.N.index_select(0, idx),
                                        arena.uimg.index_select(0, idx)])
        self.rows_pulled += len(dirty)
        self.bytes_pulled += vers.nbytes + T.nbytes + sum(r.nbytes
                                                          for r in rows)
        for k, i in enumerate(dirty):
            self._kf_cache[i] = (
                int(vers[i]),
                viz.extract_kf_grid(rows[0][k], rows[1][k], rows[2][k],
                                    rows[3][k], h, w, stride,
                                    conf_threshold))
        return n, T

    def publish(self, arena, edges_ii=None, edges_jj=None, stats=None,
                lock=None):
        """Snapshot the map into the serving buffer (viz_server.py:158).
        Call it between frames, off the frame's own work (``main.py`` does
        on a new keyframe and every 15th frame).  ``lock`` (the system's
        ``_lock``) guards the reads of an arena other threads write in
        place; without it the arena must not change meanwhile.

        Incremental: camera-frame grids are cached per keyframe, keyed by
        the row's ``N_updates`` version and by (stride, confidence
        threshold, h, w), so a publish copies only the keyframes whose
        pointmaps changed (new keyframes and the fused last one) plus the
        pose table, and composes the world map on the host from the cache.
        The blob carries per-point normals and triangle indices, which the
        page renders as points, normal-oriented surfels or a mesh."""
        msg = self.get_msg()
        n, T = self._pull(arena, lock or contextlib.nullcontext(),
                             msg.C_conf_threshold)
        if n == 0:
            pts = nrms = np.zeros((0, 3), np.float32)
            cols = np.zeros((0, 3), np.float32)
            tris = np.zeros((0, 3), np.uint32)
            T = np.zeros((0, 8), np.float32)
        else:
            pts, cols, nrms, tris = viz.compose_world_grids(
                [self._kf_cache[i][1] for i in range(n)], T)
        frusta = viz.frusta_segments(T)

        # factor-graph edge lines between keyframe centers
        esegs = np.zeros((0, 2, 3), np.float32)
        if edges_ii is not None and len(edges_ii):
            centers = T[:, :3]
            ii = np.clip(np.asarray(edges_ii), 0, n - 1)
            jj = np.clip(np.asarray(edges_jj), 0, n - 1)
            esegs = np.stack([centers[ii], centers[jj]], axis=1)

        pts32 = np.ascontiguousarray(pts, np.float32)
        cols8 = (np.clip(np.asarray(cols), 0, 1) * 255).astype(np.uint8)
        nrm8 = np.clip(np.asarray(nrms) * 127, -127, 127).astype(np.int8)
        pad1 = (-len(pts32) * 3) % 4
        pad2 = (-len(pts32) * 3) % 4
        fr32 = np.ascontiguousarray(frusta, np.float32)
        es32 = np.ascontiguousarray(esegs, np.float32)
        tri32 = np.ascontiguousarray(tris, np.uint32)
        # surfel world radius ~ the median point spacing of the cloud
        if len(pts32) > 1:
            d = np.linalg.norm(pts32[1:51] - pts32[0:50], axis=-1)
            sradius = float(np.median(d)) if len(d) else 0.01
        else:
            sradius = 0.01
        blob = (pts32.tobytes() + cols8.tobytes() + b"\0" * pad1
                + nrm8.tobytes() + b"\0" * pad2
                + fr32.tobytes() + es32.tobytes() + tri32.tobytes())
        header = struct.pack("<6I", len(pts32), len(fr32), len(es32),
                             pad1, len(tri32), pad2)
        with self._lock:
            self._blob = header + blob
            self._meta = {
                "version": self._meta["version"] + 1,
                "npts": len(pts32), "nkf": n, "nfr": len(fr32),
                "nedge": len(es32), "ntri": len(tri32),
                "sradius": sradius,
                "stats": dict(stats or {}),
                "conf": msg.C_conf_threshold,
                "frame_version": self._frame_version,
            }

    def close(self):
        """Stop serving and join the server thread, waiting at most
        ``CLOSE_TIMEOUT_S``; raises if it is still alive then."""
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=CLOSE_TIMEOUT_S)
        if self._thread.is_alive():
            raise RuntimeError("the viewer's server thread did not end")


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>SLAM live</title><style>
body{margin:0;background:#111;color:#ddd;font-family:monospace}
canvas{display:block}#hud{position:fixed;top:8px;left:8px;background:#0009;
padding:8px;border-radius:6px}button{margin-right:6px}
</style></head><body>
<div id="hud">
 <button id="pause">pause</button><button id="step">step</button>
 <select id="mode"><option value="0">points</option>
  <option value="1">surfels</option><option value="2">mesh</option></select>
 <label><input id="shownrm" type="checkbox">normals</label>
 conf <input id="conf" type="range" min="0" max="10" step="0.1" value="1.5">
 <span id="confv">1.5</span><div id="stats">connecting...</div>
</div>
<img id="preview" style="position:fixed;bottom:8px;right:8px;max-width:24%;
border:1px solid #555;border-radius:4px;display:none">
<canvas id="c"></canvas>
<script>
const canvas=document.getElementById('c');
const gl=canvas.getContext('webgl');
gl.getExtension('OES_element_index_uint');
const inst=gl.getExtension('ANGLE_instanced_arrays');
// base program serves points + mesh (pointmap/trianglemap.glsl
// counterparts) and the sprite FALLBACK surfel mode for contexts without
// instancing; true surfels use the dedicated instanced program below
const vs=`attribute vec3 p;attribute vec3 c;attribute vec3 nrm;
uniform mat4 mvp;uniform mat3 rot;uniform float ps;uniform int mode;
varying vec3 vc;varying vec3 vn;
void main(){gl_Position=mvp*vec4(p,1.0);vc=c;vn=rot*nrm;
 if(mode==1){gl_PointSize=clamp(ps/gl_Position.w,2.0,48.0);}
 else{gl_PointSize=1.5;}}`;
const fs=`precision mediump float;varying vec3 vc;varying vec3 vn;
uniform int mode;
void main(){
 vec3 col=vc;
 if(mode>0){col=vc*(0.45+0.55*abs(normalize(vn).z));}
 if(mode==1){
  vec2 o=gl_PointCoord*2.0-1.0;
  vec3 n=normalize(vn);
  float m=max(abs(n.z),0.25);
  vec2 ax=length(n.xy)>1e-3?normalize(n.xy):vec2(1.0,0.0);
  float u=dot(o,ax)/m, v=o.x*ax.y-o.y*ax.x;
  if(u*u+v*v>1.0)discard;}
 gl_FragColor=vec4(col,1.0);}`;
// surfelmap.glsl counterpart: each point expands to a quad oriented by
// its normal (tangent = cross(N, -y), bitangent = cross(N, tangent)),
// round-disk discard + Phong (kA/kD/kS 0.3/0.5/0.4, spec 32, eye-space
// light at (0.1,0.1,0)) and the show_normal debug view.  The reference
// does the expansion in a geometry shader; WebGL1 has none, so the quad
// corners come from a 4-vertex strip instanced per point.
const svs=`attribute vec2 corner;attribute vec3 p;attribute vec3 c;
attribute vec3 nrm;
uniform mat4 mvp;uniform mat4 mv;uniform mat3 rot;uniform float radius;
varying vec3 vc;varying vec3 vn;varying vec3 vpos;varying vec2 tc;
void main(){
 vec3 N=normalize(nrm);
 vec3 up=vec3(0.0,-1.0,0.0);
 vec3 t0=cross(N,up);
 vec3 tangent=length(t0)>1e-4?normalize(t0):vec3(1.0,0.0,0.0);
 vec3 bitangent=cross(N,tangent);
 vec3 wp=p+(corner.x*tangent+corner.y*bitangent)*radius;
 vpos=(mv*vec4(wp,1.0)).xyz;vn=rot*N;tc=corner;vc=c;
 gl_Position=mvp*vec4(wp,1.0);}`;
const sfs=`precision mediump float;
varying vec3 vc;varying vec3 vn;varying vec3 vpos;varying vec2 tc;
uniform int showNormal;
void main(){
 if(length(tc)>1.0)discard;
 vec3 N=normalize(vn);
 if(showNormal==1){
  vec3 Nn=vec3(N.x,-N.y,-N.z);
  gl_FragColor=vec4(-Nn*0.5+0.5,1.0);return;}
 vec3 L=normalize(vec3(0.1,0.1,0.0)-vpos);
 float lam=max(dot(N,L),0.0);
 float spec=0.0;
 if(lam>0.0){
  vec3 R=2.0*dot(L,N)*N-L;
  vec3 V=normalize(-vpos);
  spec=pow(max(dot(R,V),0.0),32.0);}
 vec3 col=vc*(0.3+lam*0.5)+vec3(1.0,1.0,1.0)*0.4*spec;
 gl_FragColor=vec4(col,1.0);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
gl.compileShader(o);return o;}
const prog=gl.createProgram();
gl.attachShader(prog,sh(gl.VERTEX_SHADER,vs));
gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,fs));
gl.linkProgram(prog);gl.useProgram(prog);
let sprog=null;
if(inst){
 sprog=gl.createProgram();
 gl.attachShader(sprog,sh(gl.VERTEX_SHADER,svs));
 gl.attachShader(sprog,sh(gl.FRAGMENT_SHADER,sfs));
 gl.linkProgram(sprog);
 if(!gl.getProgramParameter(sprog,gl.LINK_STATUS))sprog=null;
}
gl.enable(gl.DEPTH_TEST);
const pl=gl.getAttribLocation(prog,'p');
const cl=gl.getAttribLocation(prog,'c');
const nl=gl.getAttribLocation(prog,'nrm');
const mvpLoc=gl.getUniformLocation(prog,'mvp');
const rotLoc=gl.getUniformLocation(prog,'rot');
const psLoc=gl.getUniformLocation(prog,'ps');
const modeLoc=gl.getUniformLocation(prog,'mode');
let S=null;
if(sprog){
 S={corner:gl.getAttribLocation(sprog,'corner'),
    p:gl.getAttribLocation(sprog,'p'),
    c:gl.getAttribLocation(sprog,'c'),
    nrm:gl.getAttribLocation(sprog,'nrm'),
    mvp:gl.getUniformLocation(sprog,'mvp'),
    mv:gl.getUniformLocation(sprog,'mv'),
    rot:gl.getUniformLocation(sprog,'rot'),
    radius:gl.getUniformLocation(sprog,'radius'),
    showNormal:gl.getUniformLocation(sprog,'showNormal')};
}
const pbuf=gl.createBuffer(),cbuf=gl.createBuffer(),nbuf=gl.createBuffer();
const lbuf=gl.createBuffer(),lcbuf=gl.createBuffer();
const ibuf=gl.createBuffer();
const cornerBuf=gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER,cornerBuf);
gl.bufferData(gl.ARRAY_BUFFER,
 new Float32Array([-1,-1, 1,-1, -1,1, 1,1]),gl.STATIC_DRAW);
let npts=0,nlines=0,ntri=0,version=-1,frameVersion=0,ctr=[0,0,0],dist=5;
let sradius=0.01,mode=0,showNormal=0;
let rx=0.5,ry=-0.8;
async function refresh(){
 try{
  const meta=await (await fetch('/meta')).json();
  document.getElementById('stats').textContent=
   `kf ${meta.nkf} | pts ${meta.npts} | tri ${meta.ntri||0} | `+
   Object.entries(meta.stats).map(([k,v])=>k+':'+v).join(' ');
  if(meta.frame_version&&meta.frame_version!==frameVersion){
   frameVersion=meta.frame_version;
   const im=document.getElementById('preview');
   im.src='/frame?v='+frameVersion;im.style.display='block';
  }
  if(meta.version===version)return;
  version=meta.version;sradius=meta.sradius||0.01;
  const buf=await (await fetch('/cloud')).arrayBuffer();
  const hdr=new Uint32Array(buf,0,6);
  const np_=hdr[0],nfr=hdr[1],ned=hdr[2],pad1=hdr[3],nt=hdr[4],pad2=hdr[5];
  let off=24;
  const pts=new Float32Array(buf,off,np_*3);off+=np_*12;
  const cols=new Uint8Array(buf,off,np_*3);off+=np_*3+pad1;
  const nrms=new Int8Array(buf,off,np_*3);off+=np_*3+pad2;
  const fr=new Float32Array(buf,off,nfr*6);off+=nfr*24;
  const ed=new Float32Array(buf,off,ned*6);off+=ned*24;
  const tri=new Uint32Array(buf,off,nt*3);
  npts=np_;ntri=nt;
  gl.bindBuffer(gl.ARRAY_BUFFER,pbuf);
  gl.bufferData(gl.ARRAY_BUFFER,pts,gl.DYNAMIC_DRAW);
  gl.bindBuffer(gl.ARRAY_BUFFER,cbuf);
  gl.bufferData(gl.ARRAY_BUFFER,cols,gl.DYNAMIC_DRAW);
  gl.bindBuffer(gl.ARRAY_BUFFER,nbuf);
  gl.bufferData(gl.ARRAY_BUFFER,nrms,gl.DYNAMIC_DRAW);
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,ibuf);
  gl.bufferData(gl.ELEMENT_ARRAY_BUFFER,tri,gl.DYNAMIC_DRAW);
  // lines: frusta (yellow) then graph edges (cyan)
  nlines=(nfr+ned)*2;
  const lp=new Float32Array(nlines*3),lc=new Uint8Array(nlines*3);
  lp.set(fr,0);lp.set(ed,nfr*6);
  for(let i=0;i<nfr*2;i++){lc[i*3]=255;lc[i*3+1]=220;lc[i*3+2]=0;}
  for(let i=nfr*2;i<nlines;i++){lc[i*3]=0;lc[i*3+1]=255;lc[i*3+2]=255;}
  gl.bindBuffer(gl.ARRAY_BUFFER,lbuf);
  gl.bufferData(gl.ARRAY_BUFFER,lp,gl.DYNAMIC_DRAW);
  gl.bindBuffer(gl.ARRAY_BUFFER,lcbuf);
  gl.bufferData(gl.ARRAY_BUFFER,lc,gl.DYNAMIC_DRAW);
  if(npts>0&&version<=2){
   let cx=0,cy=0,cz=0;
   for(let i=0;i<npts;i++){cx+=pts[i*3];cy+=pts[i*3+1];cz+=pts[i*3+2];}
   ctr=[cx/npts,cy/npts,cz/npts];
   let m=0;for(let i=0;i<npts;i++){
    m=Math.max(m,Math.hypot(pts[i*3]-ctr[0],pts[i*3+1]-ctr[1],
     pts[i*3+2]-ctr[2]));}
   dist=m*2.0+0.5;
  }
 }catch(e){}
}
setInterval(refresh,500);refresh();
let R3=[[1,0,0],[0,1,0],[0,0,1]];
function mat(){
 const cx=Math.cos(rx),sx=Math.sin(rx),cy=Math.cos(ry),sy=Math.sin(ry);
 const a=canvas.width/canvas.height,f=1.5,n=0.01*dist,fa=100*dist;
 const R=[[cy,0,sy],[sx*sy,cx,-sx*cy],[-cx*sy,sx,cx*cy]];
 R3=R;
 let t=[0,0,0];
 for(let i=0;i<3;i++){t[i]=-(R[i][0]*ctr[0]+R[i][1]*ctr[1]+R[i][2]*ctr[2]);}
 t[2]-=dist;
 const MV=new Float32Array(16);
 for(let i=0;i<3;i++){MV[i*4]=R[0][i];MV[i*4+1]=R[1][i];MV[i*4+2]=R[2][i];}
 MV[12]=t[0];MV[13]=t[1];MV[14]=t[2];MV[15]=1;
 const P=[f/a,0,0,0, 0,f,0,0, 0,0,(fa+n)/(n-fa),-1, 0,0,2*fa*n/(n-fa),0];
 const out=new Float32Array(16);
 for(let r2=0;r2<4;r2++)for(let c2=0;c2<4;c2++){let s=0;
  for(let k=0;k<4;k++){
   const mv=(k<3)?((r2<3)?MV[k*4+r2]:0):((r2<3)?t[r2]:1);
   s+=P[c2*4+k]*mv;}
  out[c2*4+r2]=s;}
 return [out,MV];}
function bindCloudAttribs(){
 gl.bindBuffer(gl.ARRAY_BUFFER,pbuf);
 gl.enableVertexAttribArray(pl);
 gl.vertexAttribPointer(pl,3,gl.FLOAT,false,0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,cbuf);
 gl.enableVertexAttribArray(cl);
 gl.vertexAttribPointer(cl,3,gl.UNSIGNED_BYTE,true,0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,nbuf);
 gl.enableVertexAttribArray(nl);
 gl.vertexAttribPointer(nl,3,gl.BYTE,true,0,0);}
function drawSurfels(M,MV,Rf){
 gl.useProgram(sprog);
 gl.uniformMatrix4fv(S.mvp,false,M);
 gl.uniformMatrix4fv(S.mv,false,MV);
 gl.uniformMatrix3fv(S.rot,false,Rf);
 gl.uniform1f(S.radius,sradius*0.9);
 gl.uniform1i(S.showNormal,showNormal);
 gl.bindBuffer(gl.ARRAY_BUFFER,cornerBuf);
 gl.enableVertexAttribArray(S.corner);
 gl.vertexAttribPointer(S.corner,2,gl.FLOAT,false,0,0);
 inst.vertexAttribDivisorANGLE(S.corner,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,pbuf);
 gl.enableVertexAttribArray(S.p);
 gl.vertexAttribPointer(S.p,3,gl.FLOAT,false,0,0);
 inst.vertexAttribDivisorANGLE(S.p,1);
 gl.bindBuffer(gl.ARRAY_BUFFER,cbuf);
 gl.enableVertexAttribArray(S.c);
 gl.vertexAttribPointer(S.c,3,gl.UNSIGNED_BYTE,true,0,0);
 inst.vertexAttribDivisorANGLE(S.c,1);
 gl.bindBuffer(gl.ARRAY_BUFFER,nbuf);
 gl.enableVertexAttribArray(S.nrm);
 gl.vertexAttribPointer(S.nrm,3,gl.BYTE,true,0,0);
 inst.vertexAttribDivisorANGLE(S.nrm,1);
 inst.drawArraysInstancedANGLE(gl.TRIANGLE_STRIP,0,4,npts);
 inst.vertexAttribDivisorANGLE(S.p,0);
 inst.vertexAttribDivisorANGLE(S.c,0);
 inst.vertexAttribDivisorANGLE(S.nrm,0);
 gl.disableVertexAttribArray(S.corner);
 gl.disableVertexAttribArray(S.p);
 gl.disableVertexAttribArray(S.c);
 gl.disableVertexAttribArray(S.nrm);
 gl.useProgram(prog);}
function draw(){
 canvas.width=innerWidth;canvas.height=innerHeight;
 gl.viewport(0,0,canvas.width,canvas.height);
 gl.clearColor(0.06,0.06,0.08,1);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const [M,MV]=mat();
 gl.useProgram(prog);
 gl.uniformMatrix4fv(mvpLoc,false,M);
 const Rf=new Float32Array([R3[0][0],R3[1][0],R3[2][0],
  R3[0][1],R3[1][1],R3[2][1],R3[0][2],R3[1][2],R3[2][2]]);
 gl.uniformMatrix3fv(rotLoc,false,Rf);
 gl.uniform1f(psLoc,2.0*sradius*1.5*canvas.height*0.5);
 gl.uniform1i(modeLoc,mode);
 if(npts>0){
  if(mode==1&&sprog){
   drawSurfels(M,MV,Rf);
  }else{
   bindCloudAttribs();
   if(mode==2&&ntri>0){
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,ibuf);
    gl.drawElements(gl.TRIANGLES,ntri*3,gl.UNSIGNED_INT,0);
   }else{
    gl.drawArrays(gl.POINTS,0,npts);
   }
  }
 }
 if(nlines>0){
  gl.uniform1i(modeLoc,0);
  gl.disableVertexAttribArray(nl);
  gl.vertexAttrib3f(nl,0,0,1);
  gl.bindBuffer(gl.ARRAY_BUFFER,lbuf);
  gl.enableVertexAttribArray(pl);
  gl.vertexAttribPointer(pl,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,lcbuf);
  gl.enableVertexAttribArray(cl);
  gl.vertexAttribPointer(cl,3,gl.UNSIGNED_BYTE,true,0,0);
  gl.drawArrays(gl.LINES,0,nlines);
 }
 requestAnimationFrame(draw);}
let drag=false,lx=0,ly=0;
canvas.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
 ry+=(e.clientX-lx)*0.005;rx+=(e.clientY-ly)*0.005;
 lx=e.clientX;ly=e.clientY;};
canvas.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
let paused=false;
document.getElementById('pause').onclick=async()=>{
 paused=!paused;
 document.getElementById('pause').textContent=paused?'resume':'pause';
 await fetch('/ctrl?pause='+(paused?1:0));};
document.getElementById('step').onclick=()=>fetch('/ctrl?step=1');
document.getElementById('mode').onchange=e=>{mode=parseInt(e.target.value);};
document.getElementById('shownrm').onchange=e=>{
 showNormal=e.target.checked?1:0;};
const conf=document.getElementById('conf');
conf.oninput=()=>{
 document.getElementById('confv').textContent=conf.value;
 fetch('/ctrl?conf='+conf.value);};
draw();
</script></body></html>
"""
