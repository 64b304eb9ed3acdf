"""Interactive pose viewer: a browser GUI served over HTTP, on one GPU.

Counterpart of ``spef_tpu.apps.gui``: dataset / split / engine selectors,
prev / next / run-stop / reset controls, free-running playback, per-overlay
checkboxes (true / predicted / temporal x pose / keypoints / bbox) and a
live metrics table (latency, ori / pos error, ESA), as a single-page
browser app backed by a stdlib ``http.server`` endpoint.  The engine
(``engine.build_engine_variant``), the streaming temporal filter
(``temporal.inference.Inference``) and the overlays
(``utils.visualize.VisualizePose``) run server-side, with the JAX package's
``/api/state``, ``/api/frame``, ``/api/select`` and ``/api/reset`` routes and
JSON fields.

The page reads the predicted pose as the flat list ``/api/frame`` sends; the
JAX package's page indexes it as a batch (``d.pred.ori[0].map``), which
throws in the browser and stops free-running playback after one frame.

One other difference is visible: the frame goes out as PNG
(``data/png.py::encode_png``, the ``png_b64`` field, shown as a
``data:image/png`` URL) where the JAX package sends a JPEG
(``cv2.imencode(".jpg")``, ``jpeg_b64``).  The port has no JPEG encoder and
depends on no image library; PNG is lossless, so the browser shows the
overlays exactly as drawn.

Usage:
    python -m spef_tpu_torch.apps.gui --experiments experiments/train \\
        --data /path/to/dataset [--port 8008] [--device cuda]

It runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

__all__ = ["GuiBackend", "make_server", "main", "discover_experiments", "discover_splits"]


def discover_experiments(root: str) -> Dict[str, str]:
    """Experiment dirs = subdirs (or the root itself) holding config.yaml."""
    found: Dict[str, str] = {}
    if os.path.isfile(os.path.join(root, "config.yaml")):
        found[os.path.basename(os.path.abspath(root))] = root
    if os.path.isdir(root):
        for name in sorted(os.listdir(root)):
            p = os.path.join(root, name)
            if os.path.isfile(os.path.join(p, "config.yaml")):
                found[name] = p
    return found


_LABEL_FILES = ("pose.json", "train.json", "valid.json", "test.json", "real.json")


def discover_splits(data_root: str) -> Dict[str, Tuple[str, str]]:
    """Walk ``data_root`` (depth <= 3) for label JSONs -> {split: (images, labels)}.

    Covers the D-SPEED still / video layouts (``<split>/images + pose.json``),
    SPEED (``images/<split>`` + ``<split>.json``) and flat custom dirs.
    """
    splits: Dict[str, Tuple[str, str]] = {}
    root = os.path.abspath(data_root)
    for dirpath, dirnames, filenames in os.walk(root):
        if dirpath[len(root):].count(os.sep) > 3:
            dirnames[:] = []
            continue
        dirnames[:] = [d for d in dirnames if d != "images"]
        for fname in filenames:
            if fname not in _LABEL_FILES or not fname.endswith(".json"):
                continue
            labels = os.path.join(dirpath, fname)
            rel = os.path.relpath(dirpath, root)
            if fname == "pose.json":
                images = os.path.join(dirpath, "images")
                name = rel if rel != "." else os.path.basename(root)
            else:
                stem = fname[: -len(".json")]
                images = os.path.join(dirpath, "images", stem)
                if not os.path.isdir(images):
                    images = os.path.join(dirpath, "images")
                name = stem if rel == "." else f"{rel}/{stem}"
            if os.path.isdir(images):
                splits[name.replace(os.sep, "/")] = (images, labels)
    return dict(sorted(splits.items()))


class GuiBackend:
    """Engine + dataset + temporal state behind the HTTP endpoints.

    One lock: ``ThreadingHTTPServer`` handles each request on its own thread,
    but inference and the filter state are strictly sequential.
    """

    def __init__(self, experiments_root: str, data_root: str, device: str = "cuda"):
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to run the GUI on the CPU")
        self.device = device
        self.experiments = discover_experiments(experiments_root)
        if not self.experiments:
            raise SystemExit(f"no experiments (config.yaml dirs) under {experiments_root}")
        self.splits = discover_splits(data_root)
        if not self.splits:
            raise SystemExit(f"no label JSONs found under {data_root}")
        from spef_tpu_torch.data.dataset import detect_dataset

        try:  # the dataset family's temporal-filter constants
            self.dataset_kind: Optional[str] = detect_dataset(data_root)
        except Exception:
            self.dataset_kind = None
        self._lock = threading.Lock()
        self.exp_name: Optional[str] = None
        self.split_name: Optional[str] = None
        self.engine_name: str = "float"
        self.records: List = []
        self.idx = 0
        self._select(next(iter(self.experiments)), next(iter(self.splits)))

    # -- engine variants ------------------------------------------------------

    def _set_engine(self, variant: str) -> None:
        """Switch the inference target."""
        from spef_tpu_torch.engine import build_engine_variant
        from spef_tpu_torch.temporal.inference import Inference

        if variant not in self.engines:
            raise KeyError(f"engine {variant!r} not available for {self.exp_name} "
                           f"(have {self.engines})")
        model = None if variant == "exported" else self.model
        self.engine = build_engine_variant(self.experiments[self.exp_name], model,
                                           self.spe_utils, variant, device=self.device)
        self.inference = Inference(self.engine, self.spe_utils, dataset=self.dataset_kind)
        self.engine_name = variant

    # -- state management ---------------------------------------------------

    def _load_experiment(self, name: str) -> None:
        from spef_tpu_torch.codec.facade import SPEUtils
        from spef_tpu_torch.config.train_config import load_config
        from spef_tpu_torch.data.camera import load_camera
        from spef_tpu_torch.engine import discover_engine_variants
        from spef_tpu_torch.models.wrapper import import_model
        from spef_tpu_torch.quant.bitwidth import experiment_model_names
        from spef_tpu_torch.utils.visualize import VisualizePose

        exp = self.experiments[name]
        cfg = load_config(os.path.join(exp, "config.yaml"))
        self.spe_utils = SPEUtils.create(
            load_camera(cfg.DATA.PATH),
            ori_mode=cfg.MODEL.HEAD.ORI,
            n_ori_bins_per_dim=cfg.MODEL.HEAD.N_ORI_BINS_PER_DIM,
            ori_smooth_factor=cfg.DATA.ORI_SMOOTH_FACTOR,
            ori_delete_unused_bins=cfg.MODEL.HEAD.ORI_DELETE_UNUSED_BINS,
            pos_mode=cfg.MODEL.HEAD.POS,
            n_pos_bins_per_dim=cfg.MODEL.HEAD.N_POS_BINS_PER_DIM,
            pos_smooth_factor=cfg.DATA.POS_SMOOTH_FACTOR,
            use_keypoints=True,
            device=self.device,
        )
        params = os.path.join(exp, "model", "parameters.msgpack")
        backbone_name, head_name, bit_width = experiment_model_names(
            exp, cfg.MODEL.BACKBONE.NAME, cfg.MODEL.HEAD.NAME)
        self.model = import_model(
            backbone_name=backbone_name,
            head_name=head_name,
            img_size=tuple(cfg.DATA.IMG_SIZE),
            params_path=params if os.path.isfile(params) else None,
            bit_width=bit_width,
            residual=cfg.MODEL.BACKBONE.RESIDUAL,
            quantization=cfg.MODEL.QUANTIZATION or bit_width is not None,
            ori_mode=cfg.MODEL.HEAD.ORI,
            n_ori_bins=self.spe_utils.orientation.n_bins,
            pos_mode=cfg.MODEL.HEAD.POS,
            n_pos_bins=self.spe_utils.position.n_bins,
            device=self.device,
        )
        self.cfg = cfg
        self.viz = VisualizePose(self.spe_utils)
        self.exp_name = name
        self.engines = discover_engine_variants(exp)
        self._set_engine("float")

    def _load_split(self, name: str) -> None:
        from spef_tpu_torch.data.dataset import Manifest

        images, labels = self.splits[name]
        self.records = Manifest.from_json(labels, images).records
        self.split_name = name
        self.idx = 0

    def _select(self, exp: Optional[str], split: Optional[str],
                engine: Optional[str] = None) -> None:
        exp_switched = False
        if exp and exp != self.exp_name:
            if exp not in self.experiments:
                raise KeyError(f"unknown experiment {exp!r}")
            self._load_experiment(exp)
            self.reset()
            exp_switched = True
        if split and split != self.split_name:
            if split not in self.splits:
                raise KeyError(f"unknown split {split!r}")
            self._load_split(split)
            self.reset()
        if engine and engine != self.engine_name:
            if exp_switched and engine not in self.engines:
                pass  # an experiment switch carried a stale engine name: stay on float
            else:
                self._set_engine(engine)
                self.reset()

    def select(self, exp: Optional[str] = None, split: Optional[str] = None,
               engine: Optional[str] = None) -> Dict:
        with self._lock:
            self._select(exp, split, engine)
            return self.state()

    def reset(self) -> None:
        if getattr(self, "inference", None) is not None:
            self.inference.reset()

    def state(self) -> Dict:
        return {
            "experiments": list(self.experiments),
            "splits": list(self.splits),
            "experiment": self.exp_name,
            "split": self.split_name,
            "engines": self.engines,
            "engine": self.engine_name,
            "n_frames": len(self.records),
            "idx": self.idx,
            "img_size": list(self.cfg.DATA.IMG_SIZE),
        }

    # -- frame pipeline -----------------------------------------------------

    def frame(self, idx: int, video: bool, overlays: Dict[str, bool]) -> Dict:
        """Inference and overlays for frame ``idx`` -> PNG and metrics."""
        from spef_tpu_torch.data.dataset import load_image
        from spef_tpu_torch.data.png import encode_png
        from spef_tpu_torch.pose.score import score_batch

        with self._lock:
            idx = int(np.clip(idx, 0, max(len(self.records) - 1, 0)))
            rec = self.records[idx]
            image = load_image(rec.image_path, tuple(self.cfg.DATA.IMG_SIZE))
            dev = self.spe_utils.orientation.histogram.device
            ori_t = torch.as_tensor(rec.ori, device=dev)
            pos_t = torch.as_tensor(rec.pos, device=dev)
            true_pose = {"ori": rec.ori, "pos": rec.pos}
            kp = self.spe_utils.keypoints
            if kp is not None:
                k2d = kp.create_keypoints2d(ori_t, pos_t)
                true_pose["keypoints"] = k2d.cpu().numpy()
                true_pose["bbox"] = kp.create_bbox_from_keypoints(k2d).cpu().numpy()

            pose_still, latency_ms, pose_video = self.inference.predict(
                image[None], "Adaptative" if video else None)

            frame = self.viz.add_visualization(
                np.ascontiguousarray(image[..., ::-1]),
                true_pose=true_pose,
                pred_pose=pose_still,
                temp_pose=pose_video,
                show_true_pose=overlays.get("true_pose", True),
                show_pred_pose=overlays.get("pred_pose", True),
                show_temp_pose=overlays.get("temp_pose", True) and pose_video is not None,
                show_true_keypoints=overlays.get("true_kp", False),
                show_pred_keypoints=overlays.get("pred_kp", False),
                show_temp_keypoints=overlays.get("temp_kp", False) and pose_video is not None,
                show_true_bbox=overlays.get("true_bbox", False),
                show_pred_bbox=overlays.get("pred_bbox", False),
                show_temp_bbox=overlays.get("temp_bbox", False) and pose_video is not None,
            )
            png = encode_png(np.ascontiguousarray(frame[..., ::-1]))

            def metrics(pose) -> Dict[str, float]:
                m = score_batch(ori_t[None], pos_t[None],
                                torch.as_tensor(pose["ori"], device=dev)[None],
                                torch.as_tensor(pose["pos"], device=dev)[None])
                return {k: round(float(v), 4) for k, v in m.items()}

            self.idx = idx
            out = {
                "idx": idx,
                "n_frames": len(self.records),
                "filename": os.path.basename(rec.image_path),
                "latency_ms": round(latency_ms, 2),
                "still": metrics(pose_still),
                "pred": {k: np.asarray(v).round(4).tolist() for k, v in
                         pose_still.items() if k in ("ori", "pos")},
                "true": {"ori": rec.ori.round(4).tolist(), "pos": rec.pos.round(4).tolist()},
                "png_b64": base64.b64encode(png).decode("ascii"),
            }
            if pose_video is not None:
                out["video"] = metrics(pose_video)
            return out


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>spef_tpu pose viewer</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#16181d;color:#e8e8e8;display:flex}
 #left{flex:1;padding:12px}#right{width:360px;padding:12px;background:#1e2128}
 img{max-width:100%;border:1px solid #333;image-rendering:auto}
 select,button{margin:2px;padding:4px 10px;background:#2a2e38;color:#e8e8e8;border:1px solid #444;border-radius:4px}
 button:hover{background:#394050}
 table{border-collapse:collapse;width:100%;font-size:13px;margin-top:8px}
 td,th{border:1px solid #333;padding:3px 6px;text-align:right}
 th{text-align:left;color:#9ab}
 label{font-size:13px;margin-right:8px;white-space:nowrap}
 .legend span{font-size:12px;margin-right:10px}
 h3{margin:6px 0}
</style></head><body>
<div id="left">
 <div>
  <select id="exp"></select><select id="split"></select><select id="eng" title="inference engine"></select>
  <button id="prev">&#9664; prev</button><button id="next">next &#9654;</button>
  <button id="run">run</button><button id="reset">reset</button>
  <label><input type="checkbox" id="video" checked> temporal filter</label>
  <span id="pos"></span>
 </div>
 <div class="legend">
  <span style="color:#f66">RGB arrows / red = truth</span>
  <span style="color:#6f6">MYC arrows / green = prediction</span>
  <span style="color:#8af">RCA arrows / blue = temporal</span>
 </div>
 <img id="frame" alt="frame">
</div>
<div id="right">
 <h3>Overlays</h3>
 <div id="boxes"></div>
 <h3>Metrics</h3>
 <table id="met"></table>
 <h3>Pose</h3>
 <table id="pose"></table>
</div>
<script>
const $=id=>document.getElementById(id);
const OV=[["true_pose","true pose",1],["pred_pose","pred pose",1],["temp_pose","temporal pose",1],
 ["true_kp","true keypoints",0],["pred_kp","pred keypoints",0],["temp_kp","temporal keypoints",0],
 ["true_bbox","true bbox",0],["pred_bbox","pred bbox",0],["temp_bbox","temporal bbox",0]];
$("boxes").innerHTML=OV.map(([k,l,on])=>`<label><input type="checkbox" id="ov_${k}" ${on?"checked":""}> ${l}</label>`).join("<br>");
let idx=0,n=1,running=false,timer=null,busy=false;
function q(){return OV.filter(([k])=>$("ov_"+k).checked).map(([k])=>k).join(",");}
async function load(i,advance){
 if(busy)return; busy=true;
 try{
  const r=await fetch(`/api/frame?idx=${i}&video=${$("video").checked?1:0}&overlays=${q()}`);
  const d=await r.json(); idx=d.idx; n=d.n_frames;
  $("frame").src="data:image/png;base64,"+d.png_b64;
  $("pos").textContent=` frame ${idx+1}/${n} — ${d.filename} — ${d.latency_ms} ms`;
  let rows=`<tr><th></th><th>still</th><th>temporal</th></tr>`;
  for(const k of ["esa_score","ori_error","pos_error"]){
   rows+=`<tr><th>${k}</th><td>${d.still[k]}</td><td>${d.video?d.video[k]:"—"}</td></tr>`;
  }
  $("met").innerHTML=rows;
  $("pose").innerHTML=
   `<tr><th></th><th>ori (wxyz)</th><th>pos (m)</th></tr>`+
   `<tr><th>true</th><td>${d.true.ori.join(", ")}</td><td>${d.true.pos.join(", ")}</td></tr>`+
   `<tr><th>pred</th><td>${d.pred.ori.map(x=>x.toFixed(3)).join(", ")}</td><td>${d.pred.pos.map(x=>x.toFixed(2)).join(", ")}</td></tr>`;
 } finally { busy=false; }
 if(running&&advance) timer=setTimeout(()=>load((idx+1)%n,true),10);
}
async function state(){
 const d=await(await fetch("/api/state")).json();
 $("exp").innerHTML=d.experiments.map(e=>`<option ${e==d.experiment?"selected":""}>${e}</option>`).join("");
 $("split").innerHTML=d.splits.map(s=>`<option ${s==d.split?"selected":""}>${s}</option>`).join("");
 $("eng").innerHTML=d.engines.map(e=>`<option ${e==d.engine?"selected":""}>${e}</option>`).join("");
 idx=d.idx;n=d.n_frames;
}
async function select(){
 await fetch("/api/select",{method:"POST",body:JSON.stringify({experiment:$("exp").value,split:$("split").value,engine:$("eng").value})});
 await state(); load(0,false);
}
$("exp").onchange=select; $("split").onchange=select; $("eng").onchange=select;
$("prev").onclick=()=>load((idx-1+n)%n,false);
$("next").onclick=()=>load((idx+1)%n,false);
$("reset").onclick=async()=>{await fetch("/api/reset",{method:"POST"});load(idx,false);};
$("run").onclick=()=>{running=!running;$("run").textContent=running?"stop":"run";
 if(running)load((idx+1)%n,true); else clearTimeout(timer);};
document.addEventListener("keydown",e=>{if(e.key==="ArrowRight")$("next").click();
 if(e.key==="ArrowLeft")$("prev").click();if(e.key===" "){e.preventDefault();$("run").click();}});
state().then(()=>load(0,false));
</script></body></html>
"""


def make_server(backend: GuiBackend, port: int = 8008) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code: int = 200) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            u = urlparse(self.path)
            try:
                if u.path in ("/", "/index.html"):
                    self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
                elif u.path == "/api/state":
                    with backend._lock:
                        self._json(backend.state())
                elif u.path == "/api/frame":
                    qs = parse_qs(u.query)
                    wanted = set(qs.get("overlays", [""])[0].split(","))
                    overlays = {k: k in wanted for k in (
                        "true_pose", "pred_pose", "temp_pose", "true_kp", "pred_kp",
                        "temp_kp", "true_bbox", "pred_bbox", "temp_bbox")}
                    self._json(backend.frame(
                        int(qs.get("idx", ["0"])[0]),
                        qs.get("video", ["0"])[0] == "1",
                        overlays,
                    ))
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # surface errors to the client
                self._json({"error": str(e)}, 500)

        def do_POST(self):
            u = urlparse(self.path)
            try:
                if u.path == "/api/select":
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    self._json(backend.select(req.get("experiment"), req.get("split"),
                                              req.get("engine")))
                elif u.path == "/api/reset":
                    with backend._lock:
                        backend.reset()
                    self._json({"ok": True})
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:
                self._json({"error": str(e)}, 500)

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--experiments", required=True,
                        help="dir containing experiment dirs (config.yaml + model/)")
    parser.add_argument("--data", required=True, help="dataset root to browse")
    parser.add_argument("--port", type=int, default=8008)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    backend = GuiBackend(args.experiments, args.data, device=args.device)
    server = make_server(backend, args.port)
    print(f"spef_tpu pose viewer on http://127.0.0.1:{args.port} "
          f"({len(backend.experiments)} experiments, {len(backend.splits)} splits)")
    server.serve_forever()


if __name__ == "__main__":
    main()
