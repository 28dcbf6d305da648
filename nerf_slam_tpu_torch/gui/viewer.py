"""Live viewer: an HTTP endpoint over the SLAM viz stream.

NeRF-SLAM opens an interactive Open3D window with key bindings; GPU
servers are usually headless, so the live view is a small in-process HTTP
server (stdlib ``http.server`` in a daemon thread): a browser or ``curl``
gets the latest keyframe, depth and sigma heatmaps and fused render as
JPEGs (``/<name>.jpg``), the trajectory with its covariance ellipsoids
(``/state.json``), the point cloud (``/cloud.ply``, and downsampled for
the page's 3D scene, ``/cloud.json``), and sends the M/N/A/S/T/Z
commands back through the GUI -> fusion queue (``/cmd?name=...``).  The
SLAM and fusion loops never wait for a viewer: the served state is
swapped under a lock.

JPEGs are encoded by OpenCV where it imports, else by Pillow; the
constructor raises when neither does.  Neither is imported with this
module.

Usage::

    gui = LiveViewer(HeadlessGui(out_dir), port=8090)
    GuiModule(gui)    # the same visualize() / pop_commands() contract
"""
from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..utils import viz
from ..utils.evaluation import to_numpy
from .headless import backproject_packet, ply_text

_PAGE = """<!doctype html><html><head><title>nerf_slam_tpu_torch</title>
<style>body{background:#111;color:#ddd;font-family:monospace}
img{image-rendering:pixelated;margin:4px;max-width:45vw}
button{margin:2px;background:#333;color:#ddd;border:1px solid #666}
#traj{border:1px solid #444}</style></head><body>
<h3>nerf_slam_tpu_torch live viewer</h3>
<div id="stats"></div>
<div>
<button onclick="cmd('mesh')">[M]esh</button>
<button onclick="cmd('eval')">[N] eval</button>
<button onclick="cmd('toggle_mask')">[T]oggle mask</button>
<button onclick="cmd('rebuild')">[Z] rebuild</button>
<button onclick="cmd('sigma_thresh&value='+prompt('sigma thresh','10'))">
[A/S] sigma</button>
</div>
<img id="kf" src="/kf.jpg"><img id="depth" src="/depth.jpg">
<img id="sigma" src="/sigma.jpg"><img id="render" src="/render.jpg">
<br><canvas id="traj" width="480" height="480"></canvas>
<canvas id="scene" width="640" height="480"></canvas>
<div>3D scene: drag to orbit, wheel to zoom &mdash; point cloud,
keyframe frusta, pose-covariance ellipsoids (3&sigma;)</div>
<script>
function cmd(c){fetch('/cmd?name='+c)}
// ---- 3D scene state (orbit camera; no dependencies) ----
let yaw=0.6,pitch=0.4,zoom=1.0,cloud=null,traj=[];
const sc=document.getElementById('scene');
sc.onmousedown=e=>{let px=e.clientX,py=e.clientY;
 const mv=m=>{yaw+=(m.clientX-px)*0.01;pitch+=(m.clientY-py)*0.01;
  px=m.clientX;py=m.clientY;draw3d();};
 const up=()=>{window.removeEventListener('mousemove',mv);
  window.removeEventListener('mouseup',up);};
 window.addEventListener('mousemove',mv);
 window.addEventListener('mouseup',up);};
sc.onwheel=e=>{e.preventDefault();
 zoom*=Math.exp(-e.deltaY*0.001);draw3d();};
function rot(p,c){ // world -> view (orbit about cloud centroid c)
 const x=p[0]-c[0],y=p[1]-c[1],z=p[2]-c[2];
 const cy=Math.cos(yaw),sy=Math.sin(yaw);
 const cp=Math.cos(pitch),sp=Math.sin(pitch);
 const x1=cy*x+sy*z, z1=-sy*x+cy*z;
 const y1=cp*y-sp*z1, z2=sp*y+cp*z1;
 return [x1,y1,z2];}
function prj(v,ext){ // view -> canvas
 const d=3.0*ext/zoom, f=400*zoom;
 const z=v[2]+d*1.5;
 if(z<=0.05)return null;
 return [320+f*v[0]/z, 240+f*v[1]/z];}
function center(){
 if(traj.length){const n=traj.length;let c=[0,0,0];
  traj.forEach(p=>{c[0]+=p.c2w[0][3]/n;c[1]+=p.c2w[1][3]/n;
   c[2]+=p.c2w[2][3]/n;});return c;}
 return [0,0,0];}
function extent(){
 let e=1e-3;
 traj.forEach(p=>{const c=center();for(let i=0;i<3;i++)
  e=Math.max(e,Math.abs(p.c2w[i][3]-c[i]));});
 return e*2+0.5;}
function draw3d(){
 const g=sc.getContext('2d');
 g.fillStyle='#111';g.fillRect(0,0,640,480);
 const c=center(),ext=extent();
 if(cloud){g.globalAlpha=0.8;
  for(let i=0;i<cloud.pts.length;i++){
   const q=prj(rot(cloud.pts[i],c),ext);if(!q)continue;
   const col=cloud.cols[i];
   g.fillStyle='rgb('+col[0]+','+col[1]+','+col[2]+')';
   g.fillRect(q[0],q[1],2,2);}
  g.globalAlpha=1.0;}
 // camera frusta (reference draws LineSet camera actors,
 // open3d_gui.py:215-221) + 3-sigma covariance ellipses
 // (reference ellipsoid actors, open3d_gui.py:590-616)
 const s=ext*0.04;
 traj.forEach((p,k)=>{
  const M=p.c2w;
  const tf=v=>[M[0][0]*v[0]+M[0][1]*v[1]+M[0][2]*v[2]+M[0][3],
               M[1][0]*v[0]+M[1][1]*v[1]+M[1][2]*v[2]+M[1][3],
               M[2][0]*v[0]+M[2][1]*v[1]+M[2][2]*v[2]+M[2][3]];
  const o=tf([0,0,0]);
  const corners=[[-s,-s,2*s],[s,-s,2*s],[s,s,2*s],[-s,s,2*s]]
   .map(v=>tf(v));
  g.strokeStyle=k===traj.length-1?'#ff0':'#4af';g.beginPath();
  corners.forEach((q,i)=>{
   const a=prj(rot(o,c),ext),b=prj(rot(q,c),ext),
    d2=prj(rot(corners[(i+1)%4],c),ext);
   if(a&&b){g.moveTo(a[0],a[1]);g.lineTo(b[0],b[1]);}
   if(b&&d2){g.moveTo(b[0],b[1]);g.lineTo(d2[0],d2[1]);}});
  g.stroke();
  if(p.cov_radii&&p.cov_axes){ // 3 principal ellipse circles
   g.strokeStyle='rgba(255,100,100,0.7)';
   for(let a1=0;a1<3;a1++){const a2=(a1+1)%3;
    g.beginPath();let first=true;
    for(let t=0;t<=16;t++){const th=t/16*2*Math.PI;
     // radii are already 3-sigma (utils/viz.py pose_cov_ellipsoid)
     const r1=p.cov_radii[a1],r2=p.cov_radii[a2];
     const v=[0,1,2].map(i=>o[i]
      +r1*Math.cos(th)*p.cov_axes[i][a1]
      +r2*Math.sin(th)*p.cov_axes[i][a2]);
     const q=prj(rot(v,c),ext);if(!q){first=true;continue;}
     if(first){g.moveTo(q[0],q[1]);first=false;}
     else g.lineTo(q[0],q[1]);}
    g.stroke();}}});
 }
async function tick(){
 try{
  const s=await (await fetch('/state.json')).json();
  document.getElementById('stats').textContent=JSON.stringify(s.stats);
  for(const id of['kf','depth','sigma','render'])
   document.getElementById(id).src='/'+id+'.jpg?t='+Date.now();
  traj=s.trajectory||[];
  const c=document.getElementById('traj').getContext('2d');
  c.fillStyle='#111';c.fillRect(0,0,480,480);
  const tr=traj;
  if(tr.length){
   const xs=tr.map(p=>p.c2w[0][3]),zs=tr.map(p=>p.c2w[2][3]);
   const mx=Math.min(...xs),Mx=Math.max(...xs)+1e-6;
   const mz=Math.min(...zs),Mz=Math.max(...zs)+1e-6;
   const scl=440/Math.max(Mx-mx,Mz-mz);
   c.strokeStyle='#4af';c.beginPath();
   tr.forEach((p,i)=>{const x=20+(p.c2w[0][3]-mx)*scl,
    y=20+(p.c2w[2][3]-mz)*scl;i?c.lineTo(x,y):c.moveTo(x,y)});
   c.stroke();}
  draw3d();
 }catch(e){}
 setTimeout(tick,1000);}
async function cloudTick(){
 try{cloud=await (await fetch('/cloud.json')).json();draw3d();}
 catch(e){}
 setTimeout(cloudTick,5000);}
tick();cloudTick();
</script></body></html>"""


def jpeg_encoder(quality: int):
    """``encode(rgb uint8 (H, W, 3)) -> JPEG bytes`` through OpenCV, or
    Pillow where OpenCV does not import."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        params = [int(cv2.IMWRITE_JPEG_QUALITY), quality]

        def encode(rgb):
            ok, buf = cv2.imencode(".jpg", cv2.cvtColor(
                np.ascontiguousarray(rgb), cv2.COLOR_RGB2BGR), params)
            return buf.tobytes() if ok else b""
        return encode
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError("the live viewer encodes JPEGs with OpenCV (cv2) "
                           "or Pillow (PIL), and neither imports") from None

    def encode(rgb):
        out = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(rgb)).save(out, "JPEG",
                                                        quality=quality)
        return out.getvalue()
    return encode


class LiveViewer:
    """Wraps a :class:`HeadlessGui`, serving its stream over HTTP.

    A drop-in GUI for ``GuiModule``: ``visualize`` updates the served
    state, then delegates; ``pop_commands`` merges the commands sent over
    HTTP with the inner GUI's own.  ``port=0`` picks a free port
    (``self.port`` holds it)."""

    def __init__(self, gui, port: int = 8090, host: str = "0.0.0.0",
                 jpeg_quality: int = 85):
        self.gui = gui
        self.jpeg_quality = jpeg_quality
        self._encode = jpeg_encoder(jpeg_quality)
        self._lock = threading.Lock()
        self._jpgs: Dict[str, bytes] = {}
        self._cloud: Optional[bytes] = None
        self._cloud_json: Optional[bytes] = None
        self._stats: Dict[str, Any] = {}
        self._http_cmds = []
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # quiet
                pass

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif u.path == "/state.json":
                    with viewer._lock:
                        body = json.dumps({
                            "stats": viewer._stats,
                            "trajectory": viewer.gui.trajectory[-512:],
                        }).encode()
                    self._send(200, "application/json", body)
                elif u.path.endswith(".jpg"):
                    with viewer._lock:
                        data = viewer._jpgs.get(u.path[1:-4])
                    self._send_or_404(data, "image/jpeg")
                elif u.path == "/cloud.ply":
                    with viewer._lock:
                        data = viewer._cloud
                    self._send_or_404(data, "application/octet-stream")
                elif u.path == "/cloud.json":
                    with viewer._lock:
                        data = viewer._cloud_json
                    self._send_or_404(data, "application/json")
                elif u.path == "/cmd":
                    q = parse_qs(u.query)
                    name = (q.get("name") or [""])[0]
                    cmd = {"cmd": name}
                    if "value" in q:
                        cmd["value"] = float(q["value"][0])
                    if name:
                        with viewer._lock:
                            viewer._http_cmds.append(cmd)
                    self._send(200, "text/plain", b"ok")
                else:
                    self._send(404, "text/plain", b"?")

            def _send_or_404(self, data, ctype):
                if data is None:
                    self._send(404, "text/plain", b"not yet")
                else:
                    self._send(200, ctype, data)

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                try:
                    self.wfile.write(body)
                except BrokenPipeError:
                    pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]   # resolved (port 0)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="live-viewer")
        self._thread.start()

    # the GuiModule contract
    def visualize(self, packet: Optional[Dict[str, Any]]):
        out = self.gui.visualize(packet)
        if packet is not None and "cam0_poses" in packet:
            try:
                self._publish(packet)
            except Exception:   # a viewer must never stop SLAM
                pass
        return out

    def pop_commands(self):
        with self._lock:
            http_cmds, self._http_cmds = self._http_cmds, []
        # a sigma threshold sent over HTTP applies to the GUI too (A/S)
        for c in http_cmds:
            if c["cmd"] == "sigma_thresh" and "value" in c:
                self.gui.sigma_thresh = float(c["value"])
        return self.gui.pop_commands() + http_cmds

    def close(self):
        self._server.shutdown()
        self._server.server_close()

    def _publish(self, packet):
        nv = int(packet.get("viz_count", len(packet["viz_idx"])))
        img = to_numpy(packet["cam0_images"][nv - 1])
        idep = to_numpy(packet["cam0_idepths_up"][nv - 1])
        cov = to_numpy(packet["cam0_depths_cov_up"][nv - 1])
        with np.errstate(divide="ignore"):
            depth = np.where(idep > 1e-3, 1.0 / idep, 0.0)
        jpg = self._encode
        jpgs = {"kf": jpg(img.astype(np.uint8)),
                "depth": jpg(viz.depth_to_rgb(depth)),
                "sigma": jpg(viz.sigma_to_rgb(cov))}
        if "render_rgb" in packet:     # a fused render of the current view
            r = to_numpy(packet["render_rgb"])
            jpgs["render"] = jpg((np.clip(r, 0, 1) * 255).astype(np.uint8)
                                 if r.dtype != np.uint8 else r)

        cloud = cloud_json = None
        if packet.get("is_last_frame") or self.gui.n_packets % 10 == 0:
            pts, cols = backproject_packet(packet, self.gui.sigma_thresh,
                                           stride=4)
            if pts.shape[0]:
                sel = slice(None)
                if pts.shape[0] > 200000:
                    sel = np.random.RandomState(0).choice(
                        pts.shape[0], 200000, replace=False)
                cloud = ply_text(pts[sel], cols[sel]).encode()
                # a downsampled cloud for the page's 3D scene
                k = min(pts.shape[0], 12000)
                sj = np.random.RandomState(1).choice(pts.shape[0], k,
                                                     replace=False)
                cloud_json = json.dumps({
                    "pts": np.round(pts[sj], 3).tolist(),
                    "cols": cols[sj].astype(int).tolist()}).encode()

        stats = {"n_keyframes": int(np.asarray(packet["viz_idx"])[nv - 1])
                 + 1, "n_packets": self.gui.n_packets,
                 "sigma_thresh": self.gui.sigma_thresh}
        with self._lock:
            self._jpgs.update(jpgs)
            if cloud is not None:
                self._cloud = cloud
            if cloud_json is not None:
                self._cloud_json = cloud_json
            self._stats = stats
