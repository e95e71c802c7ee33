"""Live interactive 3D map viewer in the browser, without dependencies.

The port's copy of the JAX package's ``viz/web.py``. The reference's live
viewer is a moderngl+imgui OpenGL window (``mast3r_slam/visualization.py:
73-600``); a server without a display serves the same data over HTTP to a
WebGL page (no outside JS library; works through an SSH port-forward):

- ``GET /``            the viewer page (WebGL points and lines, orbit and
                       zoom, polling)
- ``GET /state.json``  keyframe poses, factor edges, counts and a
                       ``version`` that grows with each snapshot (clients
                       refetch the points only when it changes)
- ``GET /points.bin``  float32 ``[x y z conf]`` per point: the
                       confidence-gated, subsampled world points
- ``POST /control``    the control channel back to the run (the
                       reference's WindowMsg, ``visualization.py:88-91,
                       130-142,305``): JSON ``{"action": "pause" | "resume" |
                       "toggle" | "step"}``, ``{"conf_threshold": x}``,
                       ``{"teleop": "w"}``. The main loop calls
                       :meth:`WebViewer.wait_if_paused` once per frame;
                       teleop keys go to an optional ``teleop_cb``. A
                       request with a foreign ``Origin`` is refused (403).

A snapshot is taken when the keyframe count changes (the reference's dirty
flag). The store is written in place by the frontend and the backend
worker, so the snapshot copies the live slots under the store's lock and
gates and subsamples them on the device (``visualization.read_map``,
``gated_points``): one copy of at most ``max_points`` x 16 bytes, plus the
poses, reaches the host. A failed snapshot never stops the run: it is
logged with its traceback and counted in :attr:`WebViewer.errors`.

Usage::

    from frodo_slam_tpu_torch.viz.web import WebViewer
    viewer = WebViewer(slam, port=8090).start()   # background threads
    ...
    viewer.stop()
"""

from __future__ import annotations

import collections
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Deque, List, Optional, Tuple
from urllib.parse import urlsplit

import numpy as np
import torch

from ..utils.log import get_logger
from .visualization import gated_points, read_map

log = get_logger("viz.web")

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>frodo-slam-tpu live map</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:12px monospace;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#0008;padding:6px 10px;border-radius:4px}
 canvas{display:block}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">connecting…</div>
<div id="ctl" style="position:fixed;top:8px;right:8px;background:#0008;padding:6px 10px;border-radius:4px">
 <button id="bp">pause</button> <button id="bs">step</button>
 conf <input id="cf" type="range" min="0" max="10" step="0.1" style="width:90px;vertical-align:middle">
 <span id="cfv"></span>
</div>
<script>
const canvas=document.getElementById('c'),hud=document.getElementById('hud');
const gl=canvas.getContext('webgl');
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);gl.compileShader(o);return o;}
const vs=sh(gl.VERTEX_SHADER,`attribute vec3 p;attribute float c;uniform mat4 mvp;
 uniform float ps;varying float vc;void main(){gl_Position=mvp*vec4(p,1.);gl_PointSize=ps;vc=c;}`);
const fs=sh(gl.FRAGMENT_SHADER,`precision mediump float;varying float vc;uniform vec3 col;uniform float useC;
 void main(){vec3 a=mix(vec3(.2,.4,1.),vec3(1.,.9,.2),clamp(vc*.25,0.,1.));
 gl_FragColor=vec4(mix(col,a,useC),1.);}`);
const prog=gl.createProgram();gl.attachShader(prog,vs);gl.attachShader(prog,fs);gl.linkProgram(prog);
gl.useProgram(prog);
const aP=gl.getAttribLocation(prog,'p'),aC=gl.getAttribLocation(prog,'c');
const uM=gl.getUniformLocation(prog,'mvp'),uPS=gl.getUniformLocation(prog,'ps'),
      uCol=gl.getUniformLocation(prog,'col'),uUC=gl.getUniformLocation(prog,'useC');
let ptBuf=gl.createBuffer(),nPts=0,lnBuf=gl.createBuffer(),nLn=0,version=-1,state=null;
let yaw=-0.6,pitch=-0.4,dist=6,cx=0,cy=0,cz=0,drag=null;
canvas.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){cx-=dx*dist*5e-4*Math.cos(yaw);cz-=dx*dist*5e-4*Math.sin(yaw);cy+=dy*dist*5e-4;}
 else{yaw+=dx*.005;pitch+=dy*.005;}drag=[e.clientX,e.clientY,drag[2]];};
canvas.onwheel=e=>{dist*=Math.exp(e.deltaY*.001);e.preventDefault();};
function mat(){
 const W=canvas.width=innerWidth,H=canvas.height=innerHeight;gl.viewport(0,0,W,H);
 const f=1/Math.tan(.4),a=W/H,n=.01,fa=1000;
 const P=[f/a,0,0,0, 0,f,0,0, 0,0,(fa+n)/(n-fa),-1, 0,0,2*fa*n/(n-fa),0];
 const cp=Math.cos(pitch),sp=Math.sin(pitch),cyw=Math.cos(yaw),syw=Math.sin(yaw);
 const ex=cx+dist*cp*syw,ey=cy-dist*sp,ez=cz+dist*cp*cyw;
 const zx=(ex-cx)/dist,zy=(ey-cy)/dist,zz=(ez-cz)/dist;
 let xx=zz,xy=0,xz=-zx;const xl=Math.hypot(xx,xy,xz)||1;xx/=xl;xy/=xl;xz/=xl;
 const yx=zy*xz-zz*xy,yy=zz*xx-zx*xz,yz=zx*xy-zy*xx;
 const V=[xx,yx,zx,0, xy,yy,zy,0, xz,yz,zz,0,
          -(xx*ex+xy*ey+xz*ez),-(yx*ex+yy*ey+yz*ez),-(zx*ex+zy*ey+zz*ez),1];
 const M=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;for(let k=0;k<4;k++)s+=P[k*4+j]*V[i*4+k];M[i*4+j]=s;}
 return M;}
function draw(){
 gl.clearColor(.07,.07,.08,1);gl.clear(gl.COLOR_BUFFER_BIT);
 const M=mat();gl.uniformMatrix4fv(uM,false,M);
 if(nPts){gl.uniform1f(uUC,1);gl.uniform1f(uPS,2);
  gl.bindBuffer(gl.ARRAY_BUFFER,ptBuf);
  gl.enableVertexAttribArray(aP);gl.vertexAttribPointer(aP,3,gl.FLOAT,false,16,0);
  gl.enableVertexAttribArray(aC);gl.vertexAttribPointer(aC,1,gl.FLOAT,false,16,12);
  gl.drawArrays(gl.POINTS,0,nPts);}
 if(nLn){gl.uniform1f(uUC,0);gl.uniform3f(uCol,1,.3,.3);
  gl.bindBuffer(gl.ARRAY_BUFFER,lnBuf);
  gl.enableVertexAttribArray(aP);gl.vertexAttribPointer(aP,3,gl.FLOAT,false,12,0);
  gl.disableVertexAttribArray(aC);gl.vertexAttrib1f(aC,0);
  gl.drawArrays(gl.LINES,0,nLn);}
 requestAnimationFrame(draw);}
function buildLines(st){
 // trajectory polyline + factor-graph edges from keyframe positions
 const T=st.T_WC,L=[];
 for(let k=1;k<T.length;k++){L.push(...T[k-1].slice(0,3),...T[k].slice(0,3));}
 for(const [i,j] of st.edges){if(T[i]&&T[j])L.push(...T[i].slice(0,3),...T[j].slice(0,3));}
 gl.bindBuffer(gl.ARRAY_BUFFER,lnBuf);
 gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(L),gl.DYNAMIC_DRAW);nLn=L.length/3;}
// -- control channel (reference WindowMsg: pause/step/conf/teleop) --------
const bp=document.getElementById('bp'),bs=document.getElementById('bs');
const cf=document.getElementById('cf'),cfv=document.getElementById('cfv');
function ctl(body){return fetch('control',{method:'POST',body:JSON.stringify(body)});}
bp.onclick=()=>ctl({action:'toggle'});
bs.onclick=()=>ctl({action:'step'});
cf.oninput=()=>{cfv.textContent=cf.value;};
cf.onchange=()=>ctl({conf_threshold:+cf.value});
window.onkeydown=e=>{
 if(e.target.tagName==='INPUT')return;
 if(e.key===' '){ctl({action:'toggle'});e.preventDefault();}
 else if(e.key==='n'){ctl({action:'step'});}
 else if('wasd'.includes(e.key)){ctl({teleop:e.key});}};
let cfInit=false;
async function poll(){
 try{
  const st=await (await fetch('state.json')).json();
  hud.textContent=`keyframes ${st.n_kf}  frames ${st.frames}  points ${st.n_points}  v${st.version}`
   +(st.paused?'  [PAUSED]':'');
  bp.textContent=st.paused?'resume':'pause';
  if(!cfInit){cf.value=st.conf_threshold;cfv.textContent=st.conf_threshold;cfInit=true;}
  if(st.version!==version){
   version=st.version;state=st;buildLines(st);
   const buf=await (await fetch('points.bin?v='+version)).arrayBuffer();
   gl.bindBuffer(gl.ARRAY_BUFFER,ptBuf);
   gl.bufferData(gl.ARRAY_BUFFER,buf,gl.DYNAMIC_DRAW);nPts=buf.byteLength/16;}
 }catch(e){hud.textContent='disconnected: '+e;}
 setTimeout(poll,1000);}
poll();draw();
</script></body></html>"""


class WebViewer:
    """Threaded HTTP live viewer over a running :class:`SLAM` system.

    ``port=0`` binds a free port; :attr:`port` holds the bound one after
    :meth:`start`."""

    def __init__(self, slam, port: int = 8090, host: str = "127.0.0.1",
                 conf_threshold: float = 1.5, max_points: int = 400_000,
                 interval_s: float = 1.0, teleop_cb=None):
        self.slam = slam
        self.port = port
        self.host = host
        self.conf_threshold = conf_threshold
        self.max_points = max_points
        self.interval_s = interval_s
        # control channel back to the run (reference WindowMsg contract,
        # visualization.py:88-91,305): pause/step from the browser gate the
        # main loop via wait_if_paused(); teleop keys (WASD) go to an
        # optional callback (robot mode forwards them to the robot API)
        self.teleop_cb = teleop_cb
        self.errors = 0  # snapshots and teleop calls that raised
        # the last 1,000 snapshots: host ms in read_map (the store lock's
        # wait and the copies), host ms in all, bytes fetched from the device
        self.snapshot_log: Deque[Tuple[float, float, int]] = collections.deque(maxlen=1000)
        self._paused = False
        self._steps = 0
        self._holding = False
        self._resume = threading.Event()
        self._resume.set()
        self._lock = threading.Lock()
        self._version = 0
        self._last_total = -1
        self._points = np.zeros((0, 4), np.float32)
        self._state = {"version": 0, "n_kf": 0, "frames": 0, "n_points": 0,
                       "T_WC": [], "edges": []}
        self._stop = threading.Event()
        self._server: Optional[ThreadingHTTPServer] = None
        self._threads: List[threading.Thread] = []

    # -- snapshot building (dirty-flag analogue: only on keyframe change) ---

    def _snapshot(self):
        store = self.slam.store  # None while a map reset swaps the ring
        if store is None or store.n_total == self._last_total:
            return
        t0 = time.perf_counter()
        with self._lock:
            thr = self.conf_threshold
        snap = read_map(self.slam)
        read_ms = (time.perf_counter() - t0) * 1e3
        if snap is None:
            return
        packed = gated_points(snap, thr, self.max_points)
        # the one copy to the host: the points, then the poses
        host = torch.cat([packed.reshape(-1), snap.T_WC.float().reshape(-1)]).cpu().numpy()
        points = host[: packed.numel()].reshape(-1, 4)
        T = host[packed.numel():].reshape(-1, 8)
        with self._lock:
            self._version += 1
            if self.conf_threshold == thr:  # else a new gate came in: snapshot again
                self._last_total = snap.n_total
            self._points = points
            self._state = {
                "version": self._version,
                "n_kf": int(T.shape[0]),
                "frames": snap.frames,
                "n_points": int(len(points)),
                "T_WC": [[float(v) for v in row] for row in T],
                "edges": snap.live_edges(),
            }
        self.snapshot_log.append((read_ms, (time.perf_counter() - t0) * 1e3, int(host.nbytes)))

    def _count_error(self, what: str):
        """Log the exception being handled with its traceback, and count it."""
        log.exception(what)
        with self._lock:
            self.errors += 1

    # -- control channel ----------------------------------------------------

    @property
    def paused(self) -> bool:
        return self._paused

    @property
    def holding(self) -> bool:
        """True while :meth:`wait_if_paused` holds the run's next frame."""
        return self._holding

    def apply_control(self, msg: dict):
        """Apply one control message (the POST /control body). Thread-safe;
        also usable directly from embedding code/tests."""
        action = msg.get("action")
        with self._lock:
            if action in ("pause", "resume", "toggle"):
                self._paused = (
                    not self._paused if action == "toggle" else action == "pause"
                )
                if self._paused:
                    self._resume.clear()
                else:
                    self._steps = 0
                    self._resume.set()
            elif action == "step":
                self._steps += 1
                self._resume.set()
            if "conf_threshold" in msg:
                self.conf_threshold = float(msg["conf_threshold"])
                self._last_total = -1  # force a re-snapshot with the new gate
        if msg.get("teleop") and self.teleop_cb is not None:
            try:
                self.teleop_cb(str(msg["teleop"]))
            except Exception:  # the viewer must never take the SLAM down
                self._count_error("teleop callback failed")

    def wait_if_paused(self, poll_s: float = 0.05):
        """Main-loop hook, called once per frame BEFORE processing it: blocks
        while the browser has the run paused; a queued 'step' releases
        exactly one frame (reference pause/next semantics,
        visualization.py:88-91 + main.py's viz2main poll)."""
        try:
            while not self._stop.is_set():
                with self._lock:
                    if not self._paused:
                        return
                    if self._steps > 0:
                        self._steps -= 1
                        if self._steps == 0:
                            self._resume.clear()
                        return
                    self._holding = True
                self._resume.wait(poll_s)
        finally:
            self._holding = False

    # -- server -------------------------------------------------------------

    def _make_handler(viewer):  # noqa: N805 - handler factory
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html; charset=utf-8", _PAGE.encode())
                elif path == "/state.json":
                    with viewer._lock:
                        st = dict(viewer._state)
                        st["paused"] = viewer._paused
                        st["conf_threshold"] = viewer.conf_threshold
                        body = json.dumps(st).encode()
                    self._send(200, "application/json", body)
                elif path == "/points.bin":
                    with viewer._lock:
                        body = viewer._points.tobytes()
                    self._send(200, "application/octet-stream", body)
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path.split("?")[0] != "/control":
                    self._send(404, "text/plain", b"not found")
                    return
                # cross-origin guard: a fetch() with a string body is a
                # "simple request", so any web page open in the operator's
                # browser could otherwise pause the run or send teleop keys
                # that reach a real robot. Control messages are taken only
                # from the served page's own origin or from origin-less
                # local tools (curl).
                origin = self.headers.get("Origin")
                if origin is not None and urlsplit(origin).netloc != self.headers.get("Host", ""):
                    self._send(403, "text/plain", b"cross-origin control rejected")
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    msg = json.loads(self.rfile.read(n) or b"{}")
                    viewer.apply_control(msg)
                    self._send(200, "application/json", b'{"ok": true}')
                except Exception as e:
                    self._send(400, "text/plain", str(e).encode())

        return Handler

    def start(self) -> "WebViewer":
        self._server = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        self.port = self._server.server_address[1]
        t_srv = threading.Thread(target=self._server.serve_forever, daemon=True)
        t_srv.start()

        def loop():
            while not self._stop.is_set():
                try:
                    self._snapshot()
                except Exception:  # the viewer must never take the SLAM down
                    self._count_error("viewer snapshot failed")
                self._stop.wait(self.interval_s)

        t_snap = threading.Thread(target=loop, daemon=True)
        t_snap.start()
        self._threads = [t_srv, t_snap]
        return self

    def stop(self):
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
