"""Online serving: REST segmentation endpoint (PyTorch engine).

Counterpart of ``deadtrees_tpu.serve.server``: a ``GET /`` HTML landing
page, ``POST /segmentation`` taking an image upload and returning a PNG
mask (×255) with prediction stats in response headers (fraction, model
name/type, elapsed seconds), ``GET /healthz`` (liveness + loaded
configuration) and ``GET /metrics`` (Prometheus request counters).

Two backends, one per ``model_type``, as in the JAX service:
``torch`` is :class:`TorchInference` on the checkpoint: an
efficientunet++ with the fused decoder for batches of ≤32 images, any
other architecture on the plain model, and with ``tta`` dihedral views
the plain model whatever the architecture; ``exported`` is :class:`ExportedInference` on an artifact of
``infer/export.py``. Either may be served alone.

Two server flavors with the same routes:

- :func:`create_app` returns a FastAPI app when fastapi is installed;
- :func:`serve_stdlib` runs the same handlers on http.server.
"""

from __future__ import annotations

import io
import json
import logging
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np

from deadtrees_tpu_torch.serve.models import PredictionStats, predictionstats_to_str
from deadtrees_tpu_torch.utils.timer import record_execution_time

log = logging.getLogger(__name__)

LANDING_HTML = """\
<!doctype html>
<html lang="en">
  <head>
    <meta charset="utf-8">
    <title>DeadTrees Inference API</title>
  </head>
  <body>
    <h1>&#127794;&#9760;&#65039;&#127794; DeadTrees Inference API &#127794;&#9760;&#65039;</h1>
    <p>REST API for semantic segmentation of dead trees from ortho photos.</p>
    <p>POST an image to <code>/segmentation</code>
       (optional query param <code>model_type=torch</code> or
       <code>exported</code>).</p>
  </body>
</html>
"""


def serving_route(checkpoint: Union[str, Path], tta: int = 0) -> str:
    """The service's route for a checkpoint: ``"auto"`` (the fused decoder
    for batches of ≤32 images) for an efficientunet++ without TTA, else
    ``"plain"``."""
    from deadtrees_tpu_torch.core.checkpoint import load_checkpoint
    from deadtrees_tpu_torch.models import canonical_architecture

    hp = load_checkpoint(checkpoint)["hparams"]
    arch = canonical_architecture(hp.get("architecture", "efficientunet++"))
    return "auto" if arch == "efficientunetplusplus" and not tta else "plain"


class SegmentationService:
    """Model-holding core shared by both server flavors."""

    def __init__(
        self,
        checkpoint: Optional[Union[str, Path]] = None,
        exported: Optional[Union[str, Path]] = None,
        model_name: str = "bestmodel",
        batch_wait_ms: Optional[float] = None,
        max_batch: int = 32,
        tta: int = 0,
        device=None,
    ):
        """``device`` is where the engines run: CUDA unless ``"cpu"`` is
        passed; with CUDA missing and no device given this raises.
        ``checkpoint`` serves ``model_type="torch"``, ``exported`` (an
        artifact of ``infer/export.py``) ``model_type="exported"``; at
        least one is needed.

        ``tta`` (0/4/8): dihedral test-time-augmentation views
        (``infer/tta.py``), an accuracy-over-latency mode (about ``tta``
        times the device work a request). The engine contract excludes the
        fused decoder under TTA, so ``tta > 0`` serves the plain model."""
        from deadtrees_tpu_torch.infer import ExportedInference, TorchInference

        self.model_name = model_name
        self.engines: Dict[str, object] = {}
        self.batchers: Dict[str, object] = {}
        self.tta = tta
        self._metrics_lock = threading.Lock()
        self._requests: Dict[str, int] = {}
        self._errors_total = 0
        self._latency_sum = 0.0
        # API requests are small batches: an efficientunet++ checkpoint takes
        # the batch-size-aware fused route ("auto": ≤32 images on the fused
        # kernels), every other architecture the plain model; the route is
        # chosen from the checkpoint's architecture, never by catching a
        # failure. TTA asks for the plain model.
        self.route = None
        if checkpoint:
            self.route = serving_route(checkpoint, tta)
            self.engines["torch"] = TorchInference(
                checkpoint, device=device, tta=tta,
                fused_decoder="auto" if self.route == "auto" else False,
            )
        if exported:
            self.engines["exported"] = ExportedInference(exported, device=device)
        if not self.engines:
            raise ValueError("Need a checkpoint and/or exported artifact")
        if batch_wait_ms is not None:
            # dynamic batching: concurrent requests of the same image size
            # coalesce into one device dispatch (power-of-two buckets);
            # one batcher per engine
            from deadtrees_tpu_torch.serve.batching import MicroBatcher

            for name, engine in self.engines.items():
                self.batchers[name] = MicroBatcher(
                    engine.run,
                    max_batch=max_batch,
                    max_wait_ms=batch_wait_ms,
                )

    def close(self) -> None:
        """Stop the dynamic-batching workers (no-op when batching is off)."""
        for batcher in self.batchers.values():
            batcher.close()
        self.batchers.clear()

    def health(self) -> Dict:
        """``GET /healthz`` payload: liveness + the serving configuration
        an operator needs to confirm what is actually loaded."""
        return {
            "status": "ok",
            "model_name": self.model_name,
            "models": sorted(self.engines),
            "batching": bool(self.batchers),
            "tta": self.tta,
        }

    def metrics_text(self) -> str:
        """Prometheus text exposition of the request counters (the
        operator-observability analogue of the reference's per-response
        PredictionStats headers, deployment/models.py:13-14 — those report
        one request, this aggregates the process)."""
        with self._metrics_lock:
            requests = dict(self._requests)
            errors = self._errors_total
            latency = self._latency_sum
        # Only labeled series for the request counter: an unlabeled sibling
        # of the same name would double-count under sum() in PromQL.
        lines = [
            "# HELP deadtrees_requests_total Segmentation requests served.",
            "# TYPE deadtrees_requests_total counter",
        ]
        for model, n in sorted(requests.items()):
            lines.append(
                f'deadtrees_requests_total{{model_type="{model}"}} {n}'
            )
        lines += [
            "# HELP deadtrees_request_errors_total Failed segmentation requests.",
            "# TYPE deadtrees_request_errors_total counter",
            f"deadtrees_request_errors_total {errors}",
            "# HELP deadtrees_request_latency_seconds_total Cumulative "
            "segmentation latency (model time, not transfer).",
            "# TYPE deadtrees_request_latency_seconds_total counter",
            f"deadtrees_request_latency_seconds_total {latency:.6f}",
        ]
        return "\n".join(lines) + "\n"

    def _record(self, model_type: str, elapsed: float) -> None:
        with self._metrics_lock:
            self._requests[model_type] = self._requests.get(model_type, 0) + 1
            self._latency_sum += elapsed

    def _record_error(self) -> None:
        with self._metrics_lock:
            self._errors_total += 1

    def segment(
        self,
        file_bytes: bytes,
        model_type: Optional[str] = None,
        packed: bool = False,
    ) -> Tuple[bytes, Dict[str, str]]:
        """image bytes → (mask bytes, stats headers).

        ``packed=True`` returns the raw 2-bit class map (4 px/byte,
        infer/packing.py — 4× smaller than the uint8 map, ~40× smaller
        than the PNG for large scenes) with X-Packed-Shape in the headers;
        default stays the reference's PNG (mask × 255,
        deployment/server.py:111-128)."""
        from PIL import Image

        model_type = model_type or next(iter(self.engines))
        if model_type not in self.engines:
            self._record_error()
            raise ValueError(f"only {sorted(self.engines)} models allowed")
        engine = self.engines[model_type]

        try:
            image = Image.open(io.BytesIO(file_bytes)).convert("RGBA")
            arr = np.asarray(image)[None]  # (1, H, W, 4)

            with record_execution_time() as elapsed:
                batcher = self.batchers.get(model_type)
                if batcher is not None:
                    out = batcher.submit(arr[0])
                else:
                    out = engine.run(arr)[0]
        except Exception:
            self._record_error()
            raise
        self._record(model_type, elapsed())

        fraction = float((out > 0).sum() / out.size)
        stats = PredictionStats(
            fraction=fraction,
            model_name=self.model_name,
            model_type=model_type,
            elapsed=elapsed(),
        )
        headers = predictionstats_to_str(stats)

        if packed:
            from deadtrees_tpu_torch.infer.packing import pack2

            body = pack2(out.astype(np.uint8)).tobytes()
            headers["X-Packed-Shape"] = f"{out.shape[0]},{out.shape[1]}"
            return body, headers

        png = Image.fromarray(np.uint8(out * 255), "L")
        buf = io.BytesIO()
        png.save(buf, format="PNG")
        return buf.getvalue(), headers


def create_app(
    checkpoint: Optional[str] = None,
    exported: Optional[str] = None,
    service: Optional[SegmentationService] = None,
    **service_kwargs,
):
    """FastAPI app factory (reference server.py:24-29). Pass ``service`` to
    reuse an already-built engine stack (the CLI does — building a second
    one here would double the model load AND drop the CLI's batching/tta
    knobs); otherwise one is constructed from the remaining arguments."""
    from fastapi import FastAPI, File
    from starlette.responses import HTMLResponse, Response

    if service is None:
        service = SegmentationService(checkpoint, exported, **service_kwargs)
    app = FastAPI(
        title="DeadTrees image segmentation",
        description="Semantic segmentation maps of dead trees (PyTorch/CUDA).",
        version="0.1.0",
    )

    @app.get("/", response_class=HTMLResponse, include_in_schema=False)
    async def root():
        return LANDING_HTML

    @app.get("/healthz")
    async def healthz():
        return service.health()

    @app.get("/metrics")
    async def metrics():
        return Response(service.metrics_text(), media_type="text/plain")

    @app.post("/segmentation")
    def get_segmentation_map(
        file: bytes = File(...),
        model_type: Optional[str] = None,
        packed: bool = False,
    ):
        body, headers = service.segment(file, model_type, packed=packed)
        media = "application/octet-stream" if packed else "image/png"
        return Response(body, headers=headers, media_type=media)

    return app


def serve_stdlib(
    service: SegmentationService, host: str = "0.0.0.0", port: int = 8000
):
    """Dependency-free server with the same routes (http.server)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            log.debug(fmt % args)

        def do_GET(self):
            from urllib.parse import urlparse

            path = urlparse(self.path).path.rstrip("/") or "/"
            if path == "/":
                body, ctype = LANDING_HTML.encode(), "text/html"
            elif path == "/healthz":
                body, ctype = json.dumps(service.health()).encode(), "application/json"
            elif path == "/metrics":
                body, ctype = service.metrics_text().encode(), "text/plain"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            parsed = urlparse(self.path)
            if parsed.path != "/segmentation":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            if "multipart/form-data" in ctype:
                body = _extract_multipart_file(body, ctype)
            q = parse_qs(parsed.query)
            model_type = (q.get("model_type") or [None])[0]
            packed = (q.get("packed") or ["0"])[0] in ("1", "true")
            try:
                png, headers = service.segment(body, model_type, packed=packed)
            except ValueError as e:
                msg = json.dumps({"error": str(e)}).encode()
                self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(msg)))
                self.end_headers()
                self.wfile.write(msg)
                return
            self.send_response(200)
            self.send_header(
                "Content-Type",
                "application/octet-stream" if packed else "image/png",
            )
            for k, v in headers.items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(png)))
            self.end_headers()
            self.wfile.write(png)

    server = ThreadingHTTPServer((host, port), Handler)
    log.info(f"Serving on http://{host}:{port}")
    return server


def _extract_multipart_file(body: bytes, content_type: str) -> bytes:
    """Minimal multipart/form-data file extraction (first part's payload)."""
    boundary = content_type.split("boundary=")[-1].strip().encode()
    for part in body.split(b"--" + boundary):
        if b"\r\n\r\n" in part and (b"filename=" in part or b"name=" in part):
            payload = part.split(b"\r\n\r\n", 1)[1]
            return payload.rstrip(b"\r\n")
    return body


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="DeadTrees segmentation server (PyTorch)")
    ap.add_argument(
        "--checkpoint", default=None,
        help="checkpoint to serve as model_type=torch (default: "
        "checkpoints/bestmodel.ckpt unless --exported is given; '' for none)",
    )
    ap.add_argument(
        "--exported", default=None,
        help="artifact of `python -m deadtrees_tpu_torch export` to serve as "
        "model_type=exported",
    )
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument(
        "--device", default="cuda",
        help="device the engine runs on (cuda, cuda:N or cpu); raises when "
        "CUDA is asked for and missing",
    )
    ap.add_argument(
        "--batch-wait-ms", type=float, default=2.0,
        help="dynamic-batching window: concurrent same-size requests "
        "coalesce into one device dispatch (negative disables batching; "
        "0 still coalesces requests that queue up during a dispatch)",
    )
    ap.add_argument(
        "--max-batch", type=int, default=32,
        help="dynamic-batching cap (32 = the largest batch that takes the "
        "fused decoder)",
    )
    ap.add_argument(
        "--tta", type=int, default=0, choices=(0, 4, 8),
        help="test-time-augmentation views (0 = off; 4 or 8 serve the plain "
        "model over that many dihedral views)",
    )
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO)
    wait = None if args.batch_wait_ms < 0 else args.batch_wait_ms
    checkpoint = args.checkpoint
    if checkpoint is None and not args.exported:
        checkpoint = "checkpoints/bestmodel.ckpt"
    service = SegmentationService(
        checkpoint, args.exported,
        batch_wait_ms=wait, max_batch=args.max_batch, tta=args.tta,
        device=args.device,
    )
    try:
        import uvicorn

        app = create_app(service=service)
        uvicorn.run(app, host=args.host, port=args.port)
    except ImportError:
        serve_stdlib(service, args.host, args.port).serve_forever()


if __name__ == "__main__":
    main()
