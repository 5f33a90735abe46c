"""Micro-batched HTTP serving daemon for the multimodal predictor.

The reference has no serving surface at all — inference is a
one-request-at-a-time CLI (`src/predict.py:360-408`, SURVEY §1 "no
serving daemon"). This daemon wraps the same predictor (and its JSON
contract) behind HTTP so the framework covers the production-serving
shape:

  GET  /healthz            → {"status": "ok", "mode": ..., "device": ...}
  POST /predict            → the `src/predict.py:159-188` JSON contract
       body: {"image": <base64 PNG/JPEG, or path if --allow-paths>,
              "text": "...", "top_k": 5}

Serving an accelerator means feeding it batches, not single samples:
concurrent requests are aggregated by a `MicroBatcher` for a few
milliseconds (`--window-ms`) and executed as ONE forward through the
predictor's pre-compiled batch buckets, so N concurrent clients see
~one batch latency instead of N× serialized batch-1 forwards. stdlib
http.server keeps the daemon dependency-free. One process serves one
chip; scale-out is process-per-chip behind any HTTP load balancer.

Security: request bodies are untrusted. Filesystem paths in the
"image" field are rejected unless the operator opts in with
--allow-paths (optionally confined to --paths-root); the default
accepts base64 image bytes only.
"""

from __future__ import annotations

import argparse
import base64
import binascii
import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional


def _decode_image(spec: str, allow_paths: bool = False,
                  paths_root: Optional[str] = None):
    """Request image spec → np.uint8 [S,S,3].

    Base64-encoded PNG/JPEG bytes by default. Filesystem paths are an
    operator opt-in (`allow_paths`), optionally confined under
    `paths_root` so a client can't read or probe arbitrary host files.
    """
    import numpy as np
    from PIL import Image

    from multimodal_rare_disease.data.images import load_image_uint8

    if allow_paths and len(spec) < 4096 and "\n" not in spec:
        path = os.path.realpath(spec)
        inside_root = paths_root is None or os.path.commonpath(
            [os.path.realpath(paths_root), path]
        ) == os.path.realpath(paths_root)
        if inside_root and os.path.exists(path):
            return load_image_uint8(path, 256)
    try:
        raw = base64.b64decode(spec, validate=True)
    except (binascii.Error, ValueError) as e:
        hint = ("an allowed path or " if allow_paths else "")
        raise ValueError(
            f"image is neither {hint}valid base64: {e}") from e
    with Image.open(io.BytesIO(raw)) as im:
        im = im.convert("RGB")
        if im.size != (256, 256):
            im = im.resize((256, 256), Image.BILINEAR)
        return np.asarray(im, np.uint8)


class _Item:
    __slots__ = ("image", "text", "top_k", "event", "result", "error")

    def __init__(self, image, text, top_k):
        self.image = image
        self.text = text
        self.top_k = top_k
        self.event = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None


class MicroBatcher:
    """Aggregates concurrent predict requests into batched forwards.

    A worker thread owns the (non-reentrant) jitted predict path. On the
    first queued request it waits up to `window_ms` for co-arriving
    requests (or until `max_batch` are queued), then runs them as one
    `predict_batch` call through the predictor's compiled buckets.
    Under no concurrency the only cost vs. direct dispatch is the
    window wait; under load the chip sees full batches.
    """

    def __init__(self, predictor, window_ms: float = 5.0,
                 max_batch: int = 256):
        self.predictor = predictor
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        self.batch_calls = 0  # observability: number of device forwards
        self._queue: List[_Item] = []
        self._cond = threading.Condition()
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="microbatcher")
        self._worker.start()

    def submit(self, image, text, top_k: int = 5) -> dict:
        """Enqueue one request and block until its result is ready."""
        item = _Item(image, text, top_k)
        with self._cond:
            self._queue.append(item)
            self._cond.notify()
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def close(self):
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._worker.join(timeout=5)

    # -- worker ------------------------------------------------------------

    def _drain(self) -> List[_Item]:
        """Block for the first request, then collect co-arrivals for up
        to window_s (or until max_batch)."""
        with self._cond:
            while not self._queue and not self._stop:
                self._cond.wait()
            if self._stop and not self._queue:
                return []
        deadline = time.monotonic() + self.window_s
        while True:
            with self._cond:
                if len(self._queue) >= self.max_batch or self._stop:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
        with self._cond:
            batch, self._queue = (self._queue[: self.max_batch],
                                  self._queue[self.max_batch:])
        return batch

    def _run(self):
        mode = self.predictor.mode
        while True:
            batch = self._drain()
            if not batch:
                if self._stop:
                    return
                continue
            try:
                images = ([it.image for it in batch]
                          if mode != "text_only" else None)
                texts = ([it.text for it in batch]
                         if mode != "image_only" else None)
                top_k = max(it.top_k for it in batch)
                self.batch_calls += 1
                results = self.predictor.predict_batch(
                    images=images, texts=texts, top_k=top_k)
                for it, res in zip(batch, results):
                    if it.top_k < top_k:
                        res = dict(res)
                        res["predictions"] = res["predictions"][: it.top_k]
                    it.result = res
                    it.event.set()
            except Exception as e:  # noqa: BLE001 — fail the whole batch
                for it in batch:
                    it.error = e
                    it.event.set()


def make_handler(batcher: MicroBatcher, allow_paths: bool = False,
                 paths_root: Optional[str] = None):
    predictor = batcher.predictor

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload, default=float).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                import jax

                self._send(200, {"status": "ok", "mode": predictor.mode,
                                 "device": str(jax.devices()[0]),
                                 "batch_calls": batcher.batch_calls})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                image = req.get("image")
                text = req.get("text", "")
                top_k = int(req.get("top_k", 5))
                img = (_decode_image(image, allow_paths, paths_root)
                       if image is not None else None)
                if predictor.mode != "text_only" and img is None:
                    raise ValueError(
                        f"mode {predictor.mode} requires an image")
                result = batcher.submit(img, text, top_k)
                self._send(200, result)
            except Exception as e:  # noqa: BLE001 — report, don't crash
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet access log
            pass

    return Handler


from multimodal_rare_disease.cli._common import (
    add_platform_arg,
    configure_platform,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Serve the predictor over HTTP")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument("--mode", default=None)
    parser.add_argument("--window-ms", type=float, default=5.0,
                        help="micro-batch aggregation window")
    parser.add_argument("--max-batch", type=int, default=256)
    parser.add_argument("--allow-paths", action="store_true",
                        help="let requests reference local image paths")
    parser.add_argument("--paths-root", default=None,
                        help="confine --allow-paths to this directory")
    parser.add_argument("--mesh", default=None, metavar="DPxTP",
                        help="serve over a device mesh, e.g. '4x1' = "
                        "batch-sharded over 4 chips, '4x2' adds Megatron "
                        "TP of the text tower over 2 (parallel/tp.py); "
                        "default single-device")
    add_platform_arg(parser)
    args = parser.parse_args(argv)
    configure_platform(args.platform)

    from multimodal_rare_disease.inference import load_predictor

    mesh = None
    if args.mesh:
        from multimodal_rare_disease.parallel.mesh import create_mesh

        dp, _, tp = args.mesh.lower().partition("x")
        try:
            data_axis, model_axis = int(dp), int(tp or 1)
        except ValueError:
            parser.error(f"--mesh {args.mesh!r}: expected DPxTP, e.g. "
                         "'4x1' or '4x2'")
        mesh = create_mesh(data_axis=data_axis, model_axis=model_axis)

    predictor = load_predictor(args.checkpoint, mode=args.mode, mesh=mesh)
    batcher = MicroBatcher(predictor, window_ms=args.window_ms,
                           max_batch=args.max_batch)
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(batcher, allow_paths=args.allow_paths,
                     paths_root=args.paths_root))
    print(f"serving {predictor.mode} predictor on "
          f"http://{args.host}:{args.port} (POST /predict, GET /healthz; "
          f"micro-batch window {args.window_ms} ms)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
