"""Headless visualization (this system's stand-in for the reference's
PangolinViewer, reference src/viewer/PangolinViewer.{h,cpp}).

The reference runs an OpenGL render thread (trajectory, current cloud,
keyframe axes, map points, surfel discs — PangolinViewer.h:107-156). An
accelerator host is usually headless, so this module provides the same
observability as artifacts instead of a window:

  * `render_snapshot` — top-down PNG of map points + trajectory +
    keyframes (matplotlib, lazy-imported);
  * `ConsoleViewer` — the auto/step-mode frame loop controls
    (PangolinViewer.h:216-229) as a console progress line with optional
    step mode (press Enter to advance);
  * `export_state` — trajectory + map + surfels to PLY/CSV for external
    viewers (the reference's own docs recommend `evo` for trajectories).
"""
from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np

from .utils import logging_util as log


def render_snapshot(path: str, map_points: Optional[np.ndarray] = None,
                    trajectory: Optional[np.ndarray] = None,
                    keyframe_positions: Optional[np.ndarray] = None,
                    title: str = "lidar_odometry_tpu") -> bool:
    """Top-down (x, y) snapshot PNG. Returns False if matplotlib is
    unavailable (headless-minimal images)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        log.warn("[viewer] matplotlib unavailable; snapshot skipped")
        return False
    fig, ax = plt.subplots(figsize=(10, 10))
    if map_points is not None and len(map_points):
        ax.scatter(map_points[:, 0], map_points[:, 1], s=0.3, c=map_points[:, 2],
                   cmap="viridis", alpha=0.5, linewidths=0)
    if trajectory is not None and len(trajectory):
        xy = trajectory[:, :2, 3] if trajectory.ndim == 3 else trajectory[:, :2]
        ax.plot(xy[:, 0], xy[:, 1], "r-", linewidth=1.5, label="trajectory")
    if keyframe_positions is not None and len(keyframe_positions):
        ax.scatter(keyframe_positions[:, 0], keyframe_positions[:, 1],
                   s=18, c="k", marker="^", label="keyframes")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(title)
    ax.legend(loc="upper right")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    log.info("[viewer] snapshot saved: {}", path)
    return True


class ConsoleViewer:
    """Frame-loop controls mirroring the reference's auto/step modes
    (reference PangolinViewer.h:216-229, kitti_player.cpp:511-528)."""

    def __init__(self, step_mode: bool = False, print_every: int = 20):
        self.step_mode = step_mode
        self.print_every = print_every
        self._frame = 0

    def on_frame(self, pose: np.ndarray, n_points: int = 0,
                 n_keyframes: int = 0) -> bool:
        """Called once per processed frame; returns False to stop."""
        self._frame += 1
        if self._frame % self.print_every == 0 or self.step_mode:
            t = pose[:3, 3]
            sys.stderr.write(
                f"\r[frame {self._frame:5d}] pos=({t[0]:8.2f},{t[1]:8.2f},"
                f"{t[2]:6.2f}) pts={n_points:6d} kf={n_keyframes:4d}  ")
            sys.stderr.flush()
        if self.step_mode:
            try:
                line = input("  [step] Enter=next, q=quit: ")
                if line.strip().lower() == "q":
                    return False
            except EOFError:
                self.step_mode = False
        return True

    def finish(self):
        sys.stderr.write("\n")


def export_state(out_dir: str, estimator) -> None:
    """Dump everything the reference viewer showed: map PLY, trajectory
    CSV, keyframe poses, surfel centroids+normals."""
    from .io.ply import save_ply
    os.makedirs(out_dir, exist_ok=True)
    save_ply(os.path.join(out_dir, "map.ply"), estimator.map_points())
    traj = estimator.trajectory()
    np.savetxt(os.path.join(out_dir, "trajectory_xyz.csv"),
               traj[:, :3, 3], delimiter=",", header="x,y,z")
    with estimator._keyframes_lock:
        kf_pos = np.stack([kf.stored_pose[:3, 3] for kf in estimator.keyframes]) \
            if estimator.keyframes else np.zeros((0, 3))
    np.savetxt(os.path.join(out_dir, "keyframes_xyz.csv"), kf_pos, delimiter=",")

    # L1 surfels with normals + planarity (the reference viewer's
    # surfel-disc rendering data, PangolinViewer.h:131 / GetL1Surfels,
    # VoxelMap.cpp:405-418) — dumped for external inspection.
    from .ops.voxel_map import l1_surfels
    normals, centroids, planarity, valid = (
        np.asarray(a) for a in l1_surfels(estimator.map_state))
    v = np.asarray(valid, bool)
    surf = np.concatenate([centroids[v], normals[v],
                           planarity[v][:, None]], axis=1)
    np.savetxt(os.path.join(out_dir, "surfels.csv"), surf, delimiter=",",
               header="cx,cy,cz,nx,ny,nz,planarity")

    # Pre/post-ICP debug clouds of the last processed frame (the
    # reference viewer's update_icp_debug_clouds, PangolinViewer.h:137):
    # the same feature cloud transformed by the constant-velocity guess
    # vs the ICP-refined pose, for inspecting the last alignment.
    if (getattr(estimator, "_last_icp_guess", None) is not None
            and estimator._last_feat is not None):
        feat = np.asarray(estimator._last_feat)
        mask = np.asarray(estimator._last_mask, bool)
        pts = feat[mask]
        h = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], axis=1)
        pre = (h @ estimator._last_icp_guess.T)[:, :3]
        post = (h @ estimator.T_current.T)[:, :3]
        save_ply(os.path.join(out_dir, "debug_pre_icp.ply"), pre)
        save_ply(os.path.join(out_dir, "debug_post_icp.ply"), post)

    render_snapshot(os.path.join(out_dir, "snapshot.png"),
                    map_points=estimator.map_points(), trajectory=traj,
                    keyframe_positions=kf_pos)


_LIVE_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>lidar_odometry_tpu live</title>
<style>
 body{margin:0;background:#101014;color:#ddd;font:13px monospace;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#000a;padding:8px 10px;border-radius:6px}
 button{font:12px monospace;margin-right:6px;background:#2a2a33;color:#ddd;
        border:1px solid #555;border-radius:4px;padding:3px 10px;cursor:pointer}
 button:hover{background:#3a3a46}
 #help{position:fixed;bottom:8px;left:8px;color:#888}
</style></head><body>
<canvas id="cv"></canvas>
<div id="hud">
 <div id="stats">connecting...</div>
 <div style="margin-top:6px">
  <button onclick="ctl('auto')">auto</button>
  <button onclick="ctl('step')">step</button>
  <button onclick="ctl('finish')">finish</button>
 </div>
 <div style="margin-top:6px">
  <label><input type="checkbox" checked onchange="tgl('map',this)">map</label>
  <label><input type="checkbox" checked onchange="tgl('scan',this)">scan</label>
  <label><input type="checkbox" checked onchange="tgl('kf',this)">kf</label>
  <label><input type="checkbox" onchange="tgl('surfels',this)">surfels</label>
  <label><input type="checkbox" onchange="tgl('debug',this)">icp-debug</label>
 </div>
</div>
<div id="help">drag: orbit &middot; wheel: zoom &middot; shift-drag: pan</div>
<script>
const cv=document.getElementById('cv'),cx=cv.getContext('2d');
let W,H;function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;}rs();
addEventListener('resize',rs);
let yaw=-0.7,pitch=0.9,dist=120,panx=0,pany=0,drag=0,px=0,py=0;
cv.onmousedown=e=>{drag=e.shiftKey?2:1;px=e.clientX;py=e.clientY};
addEventListener('mouseup',()=>drag=0);
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-px,dy=e.clientY-py;px=e.clientX;py=e.clientY;
 if(drag==1){yaw+=dx*0.008;pitch=Math.max(0.05,Math.min(1.55,pitch+dy*0.008));}
 else{panx-=dx*dist*0.002;pany+=dy*dist*0.002;}});
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
let S=null;
const show={map:1,scan:1,kf:1,traj:1,surfels:0,debug:0};
function tgl(k,el){show[k]=el.checked?1:0;}
function proj(p){
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 let x=p[0]-panx,y=p[1]-pany,z=p[2];
 let u=cy*x+sy*y, v=-sy*x+cy*y;
 let w=cp*v+sp*z, d=-sp*v+cp*z+dist;
 if(d<0.5)return null;
 const f=0.9*Math.min(W,H)/d;
 return [W/2+u*f, H/2-w*f, f];
}
function dots(pts,col,r){cx.fillStyle=col;
 for(const p of pts){const q=proj(p);if(!q)continue;
  cx.fillRect(q[0]-r,q[1]-r,2*r,2*r);}}
function line(pts,col){cx.strokeStyle=col;cx.lineWidth=1.6;cx.beginPath();
 let first=1;for(const p of pts){const q=proj(p);if(!q){first=1;continue;}
  if(first){cx.moveTo(q[0],q[1]);first=0;}else cx.lineTo(q[0],q[1]);}
 cx.stroke();}
function surfels(ss){ // [cx,cy,cz,nx,ny,nz,plan] discs + normal ticks
 for(const s of ss){const q=proj(s);if(!q)continue;
  const g=Math.max(0,1-s[6]*8);  // greener = more planar
  cx.strokeStyle=`rgba(${140-g*80|0},${160+g*60|0},120,0.8)`;
  const r=Math.min(9,0.45*q[2]);
  cx.beginPath();cx.arc(q[0],q[1],Math.max(1.5,r),0,6.3);cx.stroke();
  const t=proj([s[0]+s[3]*0.6,s[1]+s[4]*0.6,s[2]+s[5]*0.6]);
  if(t){cx.beginPath();cx.moveTo(q[0],q[1]);cx.lineTo(t[0],t[1]);cx.stroke();}}}
function draw(){cx.fillStyle='#101014';cx.fillRect(0,0,W,H);
 if(S){
  if(S.map&&show.map)dots(S.map,'#4f7f9f',1);
  if(S.surfels&&show.surfels)surfels(S.surfels);
  if(S.pre_icp&&show.debug)dots(S.pre_icp,'#cc5fd0',1);
  if(S.post_icp&&show.debug)dots(S.post_icp,'#5fd0cc',1);
  if(S.scan&&show.scan)dots(S.scan,'#d8d44f',1);
  if(S.kf&&show.kf)dots(S.kf,'#ffffff',2);
  if(S.traj&&show.traj)line(S.traj,'#ef5350');
  if(S.traj&&S.traj.length){const q=proj(S.traj[S.traj.length-1]);
   if(q){cx.strokeStyle='#ef5350';cx.beginPath();
    cx.arc(q[0],q[1],6,0,6.3);cx.stroke();}}
 }
 requestAnimationFrame(draw);}
draw();
async function poll(){try{
  const r=await fetch('state.json');S=await r.json();
  document.getElementById('stats').textContent=
   `frame ${S.frame}  kf ${S.n_kf}  map ${S.n_map}  loops ${S.loops}  mode ${S.mode}`;
 }catch(e){}
 setTimeout(poll,500);}
poll();
function ctl(m){fetch('control?mode='+m,{method:'POST'});}
</script></body></html>"""


class LiveViewer:
    """Minimal LIVE viewer (the reference PangolinViewer's render thread +
    auto/step UI, PangolinViewer.cpp:85-129, .h:216-229) as a local HTTP
    server with a self-contained canvas renderer — no GUI stack, no
    external assets, works over an SSH port-forward to a headless
    accelerator host. Serves:

      /            the 3D view (orbit/zoom/pan; trajectory, map points,
                   current scan, keyframes)
      /state.json  the latest snapshot (downsampled)
      /control     auto/step/finish buttons -> the player's frame loop
                   (mirrors handle_viewer_controls, kitti_player.cpp:511)

    Data handoff mirrors the reference's mutex + per-frame snapshot copy
    (PangolinViewer.cpp:216-224): `update(est)` snapshots host state
    under the estimator's keyframes lock; the server thread only reads
    the latest snapshot."""

    def __init__(self, port: int = 8123, max_map_points: int = 60000,
                 max_scan_points: int = 20000, max_surfels: int = 15000):
        import http.server
        import json as _json
        import threading

        self.port = port
        self.max_map = max_map_points
        self.max_scan = max_scan_points
        self.max_surfels = max_surfels
        self._lock = threading.Lock()
        self._state_bytes = b"{}"
        self._mode = "auto"
        self._pending_steps = 0
        viewer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/state.json"):
                    with viewer._lock:
                        body = viewer._state_bytes
                    self._send(200, body, "application/json")
                else:
                    self._send(200, _LIVE_HTML.encode(), "text/html")

            def do_POST(self):
                if self.path.startswith("/control"):
                    mode = self.path.split("mode=")[-1]
                    with viewer._lock:
                        if mode == "step":
                            viewer._mode = "step"
                            viewer._pending_steps += 1
                        elif mode in ("auto", "finish"):
                            viewer._mode = mode
                    self._send(200, b"ok", "text/plain")
                else:
                    self._send(404, b"", "text/plain")

        self._json = _json
        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port),
                                                      Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        log.info("[viewer] live viewer at http://127.0.0.1:{}/", self.port)

    # -- player-side API (mirrors the reference viewer update calls) --

    def update(self, estimator) -> None:
        """Snapshot the estimator's host state for the render thread."""
        traj = estimator.trajectory()
        with estimator._keyframes_lock:
            kf = (np.stack([k.stored_pose[:3, 3] for k in estimator.keyframes])
                  if estimator.keyframes else np.zeros((0, 3), np.float32))
        mp = estimator.map_points()
        n_map = len(mp)   # true size BEFORE downsampling (round-4 ADVICE 2)
        if len(mp) > self.max_map:
            mp = mp[:: len(mp) // self.max_map + 1]
        scan = np.zeros((0, 3), np.float32)
        pre = post = None
        if getattr(estimator, "_last_feat", None) is not None:
            feat = np.asarray(estimator._last_feat)
            mask = np.asarray(estimator._last_mask, bool)
            pts = feat[mask]
            h = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1)
            scan = (h @ estimator.T_current.T)[:, :3]
            if len(scan) > self.max_scan:
                scan = scan[:: len(scan) // self.max_scan + 1]
            # Pre/post-ICP debug clouds of the last per-frame-path frame
            # (reference update_icp_debug_clouds, PangolinViewer.h:137):
            # the same features at the constant-velocity guess vs the
            # ICP-refined pose. Chunked runs only have them on
            # stage-sampled frames.
            if getattr(estimator, "_last_icp_guess", None) is not None:
                pre = (h @ estimator._last_icp_guess.T)[:, :3]
                if len(pre) > self.max_scan:
                    pre = pre[:: len(pre) // self.max_scan + 1]
                post = scan
        # L1 surfel discs (reference draw_voxel_surfels from GetL1Surfels,
        # PangolinViewer.h:131 / VoxelMap.cpp:405-418): centroid + normal
        # + planarity per surfel, rendered as discs with normal ticks.
        surf = None
        try:
            from .ops.voxel_map import l1_surfels
            nrm, cen, plan, valid = (np.asarray(a) for a in
                                     l1_surfels(estimator.map_state))
            v = np.asarray(valid, bool)
            surf = np.concatenate([cen[v], nrm[v], plan[v][:, None]], axis=1)
            if len(surf) > self.max_surfels:
                surf = surf[:: len(surf) // self.max_surfels + 1]
        except Exception:
            pass
        state = {
            "frame": int(estimator.frame_count),
            "n_kf": int(len(kf)),
            "n_map": int(n_map),
            "loops": int(estimator.loop_constraint_count),
            "mode": self._mode,
            "traj": np.round(traj[:, :3, 3], 3).tolist(),
            "kf": np.round(kf, 3).tolist(),
            "map": np.round(mp, 3).tolist(),
            "scan": np.round(scan, 3).tolist(),
        }
        if surf is not None:
            state["surfels"] = np.round(surf, 3).tolist()
        if pre is not None:
            state["pre_icp"] = np.round(pre, 3).tolist()
            state["post_icp"] = np.round(post, 3).tolist()
        body = self._json.dumps(state).encode()
        with self._lock:
            self._state_bytes = body

    @property
    def mode(self) -> str:
        """Locked view of the control mode (the player loop reads this;
        control POSTs mutate it from the HTTP thread — round-4 ADVICE 4)."""
        with self._lock:
            return self._mode

    def wait_if_stepping(self, poll_s: float = 0.05) -> bool:
        """Frame-loop gate (reference handle_viewer_controls): returns
        False when the user pressed finish; in step mode blocks until a
        step is granted."""
        import time as _time
        while True:
            with self._lock:
                if self._mode == "finish":
                    return False
                if self._mode == "auto":
                    return True
                if self._pending_steps > 0:
                    self._pending_steps -= 1
                    return True
            _time.sleep(poll_s)

    def close(self):
        try:
            self._httpd.shutdown()
        except Exception:
            pass
