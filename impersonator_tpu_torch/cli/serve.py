"""Inference server for motion imitation over HTTP (torch port of
``impersonator_tpu/cli/serve.py``): the stdlib ThreadingHTTPServer, one
process per card, or one for every visible card with ``--data_parallel``
(each request's frame batches split over them).

    python -m impersonator_tpu_torch.cli.serve --port 8080 \\
        [--image_size 256 --batch 8 --device cpu]

Endpoints (JSON unless noted):
  GET  /healthz         -> {"ok": true, "backend": "cuda" | "cpu",
                            "personalized": ...}
  POST /personalize     -> body: JPEG / PNG bytes. Optional header X-Smpl:
                           85 comma-separated floats (no HMR).
  POST /imitate         -> {"smpls": [[85 floats], ...]} -> base64 JPEG
                           frames, quantised to uint8 and encoded by the
                           device's codec (nvJPEG on the card, libjpeg on
                           the CPU).
  POST /imitate_frames  -> {"frames": [base64 JPEG / PNG, ...]}: HMR on each
                           frame, then imitation.
  POST /imitate_video   -> {"smpls": [...], "fps": 25} -> video/mp4 bytes
                           from device-packed I420; needs ffmpeg on the host
                           (400 without it).

One worker thread runs all model work, one request at a time (the JAX
service's lock): the handler threads share the card's one set of
weights, and none of them touches a device tensor of the model. The
server starts a thread for every request, and PyTorch keeps cuDNN's
execution plans per thread, so model work on the handler's own thread
would build them again for every request; the worker keeps them. The
worker runs under ``torch.no_grad()`` (grad mode is per thread). Frames
decode on the handler threads. A bad request gets a 400 and the server
keeps serving.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from impersonator_tpu_torch.config import TestConfig, from_args
from impersonator_tpu_torch.data import native
from impersonator_tpu_torch.ops.colorspace import rgb_to_i420, rgb_to_u8
from impersonator_tpu_torch.utils.cv_utils import resize_img_hwc


class ImitatorService:
    """The model behind the HTTP layer; also usable in-process."""

    def __init__(self, cfg: TestConfig, batch: int = 8,
                 data_parallel: bool = False, device="cuda"):
        from impersonator_tpu_torch.cli.run_imitator import (
            data_parallel_mesh)
        from impersonator_tpu_torch.tasks.imitator import Imitator
        self.cfg = cfg
        self.batch = batch
        self.device = torch.device(device)
        mesh = data_parallel_mesh(self.device) if data_parallel else None
        self.imitator = Imitator(cfg, device=self.device, mesh=mesh)
        self.backend = self.device.type
        self._worker = ThreadPoolExecutor(1, thread_name_prefix="imitator")

    def close(self):
        self._worker.shutdown()

    def _run(self, fn):
        """fn() on the worker thread under torch.no_grad(), after the
        requests before it."""
        def call():
            with torch.no_grad():
                return fn()
        return self._worker.submit(call).result()

    def _decode(self, data: bytes, image_size: int) -> np.ndarray:
        try:
            img = native.decode(data, self.device)
        except ValueError as e:
            raise ValueError(f"undecodable image payload ({e})") from None
        return resize_img_hwc(img, image_size)

    def _jpegs(self, infer) -> list:
        """JPEG bytes of each frame of infer()'s preds, quantised and
        encoded on the device (on the worker)."""
        return [native.encode_jpeg(f, device=self.device)
                for f in rgb_to_u8(infer())]

    def personalize(self, img_bytes: bytes, smpl=None) -> dict:
        img = self._decode(img_bytes, self.cfg.image_size)
        t0 = time.perf_counter()

        def work():
            self.imitator.personalize(img, src_smpl=smpl)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._run(work)
        return {"ok": True, "seconds": round(time.perf_counter() - t0, 3)}

    def _require_source(self):
        if self.imitator.src_info is None:
            raise ValueError("personalize first")

    def imitate(self, smpls: np.ndarray) -> dict:
        self._require_source()
        t0 = time.perf_counter()
        jpegs = self._run(lambda: self._jpegs(
            lambda: self.imitator.inference_by_smpls(
                smpls, cam_strategy=self.cfg.cam_strategy,
                batch=self.batch)))
        dt = time.perf_counter() - t0
        return {"ok": True,
                "frames": [base64.b64encode(j).decode("ascii")
                           for j in jpegs],
                "seconds": round(dt, 3),
                "fps": round(len(smpls) / max(dt, 1e-9), 1)}

    def imitate_frames(self, frames_b64: list) -> dict:
        self._require_source()
        imgs = np.stack([self._decode(base64.b64decode(b), 224)
                         for b in frames_b64])
        t0 = time.perf_counter()
        jpegs = self._run(lambda: self._jpegs(
            lambda: self.imitator.inference(
                imgs, cam_strategy=self.cfg.cam_strategy,
                batch=self.batch)))
        dt = time.perf_counter() - t0
        return {"ok": True,
                "frames": [base64.b64encode(j).decode("ascii")
                           for j in jpegs],
                "seconds": round(dt, 3),
                "fps": round(len(imgs) / max(dt, 1e-9), 1)}

    def imitate_video(self, smpls: np.ndarray, fps: int = 25) -> bytes:
        """Imitate and encode to mp4 from device-packed I420."""
        self._require_source()
        from impersonator_tpu_torch.utils.video import i420_to_mp4
        packed = self._run(lambda: rgb_to_i420(
            self.imitator.inference_by_smpls(
                smpls, cam_strategy=self.cfg.cam_strategy,
                batch=self.batch)).cpu().numpy())
        with tempfile.TemporaryDirectory() as td:
            path = i420_to_mp4(packed, os.path.join(td, "pred.mp4"), fps=fps)
            with open(path, "rb") as f:
                return f.read()


def _smpls(req) -> np.ndarray:
    smpls = np.asarray(req["smpls"], np.float32)
    if smpls.ndim != 2 or smpls.shape[1] != 85:
        raise ValueError("smpls must be (N, 85)")
    return smpls


def make_server(service: ImitatorService, host: str = "127.0.0.1",
                port: int = 8080):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply(self, code: int, payload: dict):
            self._send(code, json.dumps(payload).encode(),
                       "application/json")

        def log_message(self, fmt, *args):  # quiet access log
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {
                    "ok": True, "backend": service.backend,
                    "personalized": service.imitator.src_info is not None})
            else:
                self._reply(404, {"ok": False, "error": "not found"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", "0"))
            data = self.rfile.read(n)
            try:
                if self.path == "/personalize":
                    hdr = self.headers.get("X-Smpl")
                    smpl = (np.asarray([float(v) for v in hdr.split(",")],
                                       np.float32) if hdr else None)
                    if smpl is not None and smpl.shape != (85,):
                        raise ValueError("X-Smpl must be 85 floats")
                    self._reply(200, service.personalize(data, smpl))
                elif self.path == "/imitate":
                    self._reply(200, service.imitate(_smpls(json.loads(data))))
                elif self.path == "/imitate_frames":
                    req = json.loads(data)
                    self._reply(200, service.imitate_frames(req["frames"]))
                elif self.path == "/imitate_video":
                    if shutil.which("ffmpeg") is None:
                        raise ValueError("ffmpeg not available on host")
                    req = json.loads(data)
                    mp4 = service.imitate_video(
                        _smpls(req), fps=int(req.get("fps", 25)))
                    self._send(200, mp4, "video/mp4")
                else:
                    self._reply(404, {"ok": False, "error": "not found"})
            except Exception as e:  # one bad request must not stop serving
                self._reply(400, {"ok": False, "error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    cfg = from_args(TestConfig, argv)
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--data_parallel", action="store_true",
                    help="split request batches over the visible cards")
    ap.add_argument("--device", default="cuda")
    extra, _ = ap.parse_known_args(argv)

    service = ImitatorService(cfg, batch=extra.batch,
                              data_parallel=extra.data_parallel,
                              device=extra.device)
    server = make_server(service, extra.host, extra.port)
    print(f"serving motion imitation on {extra.host}:{server.server_port} "
          f"(backend={service.backend}, image_size={cfg.image_size})",
          flush=True)
    try:
        server.serve_forever()
    finally:
        service.close()


if __name__ == "__main__":
    main()
