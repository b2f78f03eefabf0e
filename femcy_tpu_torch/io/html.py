"""Self-contained interactive HTML export of the deformed, stress-colored mesh.

The reference's only interactive visualization is the Taichi GUI window
(body.show, the reference's body.py:100-162) -- unusable on a
display-less accelerator host.  This writes ONE .html file with the surface triangulation, nodal
field and a ~100-line vanilla-JS viewer (canvas 2D, painter's algorithm,
drag-to-rotate / wheel-to-zoom, per-face colors + a colorbar).  No network,
no external libraries: the file works from a local open or an artifact
store.

Host copy of ``femcy_tpu.io.html`` (numpy arrays in, one file out).
"""

from __future__ import annotations

import html as _html
import json

import numpy as np

from femcy_tpu_torch.mesh import FEMesh


def _turbo(x):
    """Compact turbo colormap approximation: (N,) in [0,1] -> (N, 3) uint8."""
    x = np.clip(np.asarray(x, dtype=np.float64), 0.0, 1.0)
    r = np.clip(
        34.61 + x * (1172.33 + x * (-10793.56 + x * (33300.12 + x * (-38394.49 + x * 14825.05)))),
        0, 255,
    )
    g = np.clip(
        23.31 + x * (557.33 + x * (1225.33 + x * (-3574.96 + x * (1073.77 + x * 707.56)))),
        0, 255,
    )
    b = np.clip(
        27.2 + x * (3211.1 + x * (-15327.97 + x * (27814.0 + x * (-22569.18 + x * 6838.66)))),
        0, 255,
    )
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


_VIEWER_JS = """
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let W,H;function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight-40;draw();}
let rx=-0.9,rz=0.6,zoom=1,panx=0,pany=0;
function draw(){
 ctx.fillStyle='#101014';ctx.fillRect(0,0,W,H);
 const cx=Math.cos(rx),sx=Math.sin(rx),cz=Math.cos(rz),sz=Math.sin(rz);
 const s=zoom*Math.min(W,H)*0.8/D.scale;
 const P=new Float32Array(D.pos.length);
 for(let i=0;i<D.pos.length;i+=3){
  let x=D.pos[i]-D.c[0],y=D.pos[i+1]-D.c[1],z=D.pos[i+2]-D.c[2];
  let x1=x*cz-y*sz,y1=x*sz+y*cz;
  let y2=y1*cx-z*sx,z2=y1*sx+z*cx;
  P[i]=W/2+panx+x1*s;P[i+1]=H/2+pany-z2*s;P[i+2]=y2;
 }
 const T=D.tri,n=T.length/3,ord=new Array(n);
 for(let t=0;t<n;t++)ord[t]=t;
 ord.sort((a,b)=>(P[T[3*a]*3+2]+P[T[3*a+1]*3+2]+P[T[3*a+2]*3+2])-(P[T[3*b]*3+2]+P[T[3*b+1]*3+2]+P[T[3*b+2]*3+2]));
 for(const t of ord){
  const a=T[3*t]*3,b=T[3*t+1]*3,c2=T[3*t+2]*3;
  ctx.fillStyle=D.col[t];ctx.strokeStyle=D.col[t];
  ctx.beginPath();ctx.moveTo(P[a],P[a+1]);ctx.lineTo(P[b],P[b+1]);
  ctx.lineTo(P[c2],P[c2+1]);ctx.closePath();ctx.fill();ctx.stroke();
 }
 // colorbar
 const g=ctx.createLinearGradient(20,H-30,220,H-30);
 for(let i=0;i<=10;i++)g.addColorStop(i/10,D.cbar[i]);
 ctx.fillStyle=g;ctx.fillRect(20,H-26,200,14);
 ctx.fillStyle='#ddd';ctx.font='12px sans-serif';
 ctx.fillText(D.vmin.toPrecision(4),20,H-32);
 ctx.fillText(D.vmax.toPrecision(4),180,H-32);
}
let drag=false,px=0,py=0;
cv.onmousedown=e=>{drag=true;px=e.clientX;py=e.clientY;};
onmouseup=()=>drag=false;
onmousemove=e=>{if(!drag)return;
 if(e.shiftKey){panx+=e.clientX-px;pany+=e.clientY-py;}
 else{rz+=(e.clientX-px)*0.01;rx+=(e.clientY-py)*0.01;}
 px=e.clientX;py=e.clientY;draw();};
cv.onwheel=e=>{e.preventDefault();zoom*=Math.exp(-e.deltaY*0.001);draw();};
onresize=rs;rs();
"""


def export_html(
    mesh: FEMesh,
    dof: np.ndarray,
    nodal_vals: np.ndarray,
    path: str,
    title: str = "femcy-tpu result",
    deform_scale: float = 1.0,
    field_name: str = "mises",
):
    """Write an interactive single-file HTML view of the deformed surface.

    nodal_vals: (E, n_nodes) patch-extrapolated values (FEMSystem.extrapolate).
    """
    return export_html_blocks(
        [mesh], dof, [nodal_vals], path,
        title=title, deform_scale=deform_scale, field_name=field_name,
    )


def export_html_blocks(
    meshes,  # list of FEMesh sharing one node table
    dof: np.ndarray,
    nodal_vals_per_mesh,  # list of (E_b, n_nodes_b) patch values
    path: str,
    title: str = "femcy-tpu result",
    deform_scale: float = 1.0,
    field_name: str = "mises",
):
    """Multi-block twin of export_html: every block's surface triangles go
    into ONE painter's-algorithm scene with a SHARED color scale (blocks
    share the node table, so triangle indices concatenate directly)."""
    from femcy_tpu_torch.io.export import _patch_vertex_values

    mesh = meshes[0]
    dof = np.asarray(dof)
    coords = mesh.nodes + deform_scale * dof.reshape(-1, mesh.dm)
    pos3 = np.zeros((mesh.n_nodes, 3))
    pos3[:, : mesh.dm] = coords

    per_block = [
        _patch_vertex_values(m, np.asarray(v))
        for m, v in zip(meshes, nodal_vals_per_mesh)
    ]
    tris = np.concatenate([t for t, _ in per_block], axis=0)
    face_vals = np.concatenate([v.mean(axis=1) for _, v in per_block])
    vmin, vmax = float(face_vals.min()), float(face_vals.max())
    t = (face_vals - vmin) / (vmax - vmin + 1e-30)
    rgb = _turbo(t)
    colors = [f"#{r:02x}{g:02x}{b:02x}" for r, g, b in rgb]
    cbar = [f"#{r:02x}{g:02x}{b:02x}" for r, g, b in _turbo(np.linspace(0, 1, 11))]

    lo, hi = pos3.min(axis=0), pos3.max(axis=0)
    data = {
        "pos": np.round(pos3, 6).reshape(-1).tolist(),
        "tri": tris.astype(int).reshape(-1).tolist(),
        "col": colors,
        "c": ((lo + hi) / 2).tolist(),
        "scale": float(np.max(hi - lo) + 1e-30),
        "vmin": vmin,
        "vmax": vmax,
        "cbar": cbar,
    }
    title = _html.escape(title)
    field_name = _html.escape(field_name)
    html = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>body{{margin:0;background:#101014;color:#ddd;font:14px sans-serif}}
#h{{height:40px;line-height:40px;padding:0 12px}}</style></head>
<body><div id="h">{title} — {field_name} (drag: rotate, shift-drag: pan,
wheel: zoom)</div><canvas id="c"></canvas>
<script>const D={json.dumps(data)};{_VIEWER_JS}</script></body></html>
"""
    with open(path, "w") as fh:
        fh.write(html)
    return path
