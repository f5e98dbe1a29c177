"""HTTP front: ``python -m distributedpytorch_tpu_torch.serve``.

A stdlib ``http.server`` shell around :class:`service.InferenceService`;
each request thread submits into the shared queue and blocks on its future.

    POST /v1/predict   {"image": <wire array>, "points": [[x, y]] * 4,
                        "deadline_ms": optional}
                    -> {"mask": <wire array>, "latency_ms": ...}
                       429 shed (queue full) | 504 deadline | 400 bad input
                       | 503 service stopped or no result in time
    GET  /healthz   -> 200 / 503 with the service's health
    GET  /stats     -> the metrics snapshot

The model is DANet with random weights from a seed (``--fresh-init
SIZE:BACKBONE:SEED``), a saved ``state_dict`` of the port's DANet
(``--state-dict PTH``), or a training run of the port (``--run-dir RUN``,
its best checkpoint, or ``--step N``).  It runs on CUDA unless ``--device
cpu``, in float32 with TF32 off, or in the run's precision with
``--run-dir`` (a bf16 run serves in bf16 on its float32 weights).
SIGTERM/SIGINT stop the server, fail the queued requests and exit 0.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .client import decode_array, encode_array
from .service import (
    DeadlineExceededError,
    InferenceService,
    QueueFullError,
    ServiceUnhealthyError,
)


def make_handler(service: InferenceService,
                 request_timeout_s: float = 120.0) -> type:
    """The request-handler class closed over the shared service;
    ``request_timeout_s`` bounds how long a handler waits on its future."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = 10.0  # idle keep-alive bound

        def log_message(self, fmt, *args):  # quiet: /stats is the log
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if code == 429:
                self.send_header("Retry-After", "1")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802 — http.server's contract
            if self.path == "/healthz":
                health = service.health()
                self._reply(200 if health["ok"] else 503, health)
            elif self.path == "/stats":
                self._reply(200, service.metrics.snapshot())
            else:
                self._reply(404, {"error": f"no such path {self.path!r}"})

        def do_POST(self) -> None:  # noqa: N802
            try:
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            except (TimeoutError, OSError, ValueError):
                self.close_connection = True
                return
            if self.path != "/v1/predict":
                self._reply(404, {"error": f"no such path {self.path!r}"})
                return
            try:
                body = json.loads(raw.decode("utf-8"))
                image = decode_array(body["image"])
                points = np.asarray(body["points"], np.float64)
                deadline_ms = body.get("deadline_ms")
                deadline_s = None if deadline_ms is None \
                    else float(deadline_ms) / 1e3
                t0 = time.perf_counter()
                fut = service.submit(image, points, deadline_s=deadline_s)
                mask = fut.result(timeout=request_timeout_s
                                  if deadline_s is None
                                  else min(deadline_s + 5.0, request_timeout_s))
                self._reply(200, {
                    "mask": encode_array(mask),
                    "latency_ms": (time.perf_counter() - t0) * 1e3})
            except QueueFullError as e:
                self._reply(429, {"error": str(e)})
            except DeadlineExceededError as e:
                self._reply(504, {"error": str(e)})
            except FuturesTimeoutError:
                self._reply(503, {"error": "no result within the server-side "
                                           "wait bound; check /healthz"})
            except ServiceUnhealthyError as e:
                self._reply(503, {"error": str(e)})
            except (KeyError, TypeError, ValueError) as e:
                self._reply(400, {"error": f"bad request: {e}"})

    return Handler


def make_server(service: InferenceService, host: str = "127.0.0.1",
                port: int = 8801) -> ThreadingHTTPServer:
    """The HTTP front over ``service`` (port 0 picks a free one); call
    ``serve_forever`` on it, ``shutdown`` + ``server_close`` to stop."""
    server = ThreadingHTTPServer((host, port), make_handler(service))
    server.daemon_threads = True
    return server


def build_predictor(args):
    """The served Predictor from ``--fresh-init``, ``--state-dict`` or
    ``--run-dir``."""
    import torch

    from ..models import build_model
    from ..predict import Predictor

    if args.run_dir:
        return Predictor.from_run(args.run_dir, step=args.step,
                                  device=args.device)
    if args.fresh_init:
        parts = args.fresh_init.split(":")
        if len(parts) != 3:
            raise SystemExit(f"--fresh-init wants SIZE:BACKBONE:SEED, got "
                             f"{args.fresh_init!r}")
        size, backbone, seed = int(parts[0]), parts[1], int(parts[2])
        return Predictor.fresh(size, backbone, seed=seed, device=args.device)
    model = build_model("danet", nclass=1, backbone=args.backbone,
                        output_stride=8)
    state = torch.load(args.state_dict, map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    return Predictor(model, resolution=(args.resolution, args.resolution),
                     device=args.device)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="distributedpytorch_tpu_torch.serve",
        description="Batched click-to-mask inference over HTTP (PyTorch/CUDA)")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--fresh-init", metavar="SIZE:BACKBONE:SEED",
                     help="serve DANet with random weights drawn from SEED "
                          "at SIZE² (e.g. 512:resnet101:0)")
    src.add_argument("--state-dict", metavar="PTH",
                     help="a torch state_dict of the port's DANet")
    src.add_argument("--run-dir", metavar="RUN",
                     help="a training run of the port (config.json + "
                          "checkpoints/)")
    parser.add_argument("--step", type=int, default=None,
                        help="--run-dir: this committed step instead of the "
                             "best checkpoint")
    parser.add_argument("--backbone", default="resnet101",
                        help="backbone of --state-dict's DANet")
    parser.add_argument("--resolution", type=int, default=512,
                        help="crop size of --state-dict's DANet")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu only on request)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8801)
    parser.add_argument("--max-batch", type=int, default=8,
                        help="top micro-batch bucket (power of two)")
    parser.add_argument("--queue-depth", type=int, default=64,
                        help="bounded request queue; full sheds with 429")
    parser.add_argument("--max-wait-ms", type=float, default=5.0,
                        help="batcher hold time waiting to fill a bucket")
    parser.add_argument("--deadline-ms", type=float, default=None,
                        help="default per-request deadline (none = wait)")
    parser.add_argument("--warmup", action="store_true",
                        help="run every bucket once before taking traffic")
    args = parser.parse_args(argv)

    predictor = build_predictor(args)
    service = InferenceService(
        predictor, max_batch=args.max_batch, queue_depth=args.queue_depth,
        max_wait_s=args.max_wait_ms / 1e3,
        default_deadline_s=None if args.deadline_ms is None
        else args.deadline_ms / 1e3)
    if args.warmup:
        service.warmup()
    service.start()
    httpd = make_server(service, args.host, args.port)

    def on_signal(signum, frame):
        # shutdown() must come from another thread than serve_forever's
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    print(json.dumps({"serving": f"http://{args.host}:{httpd.server_port}",
                      "device": str(predictor.device),
                      "dtype": str(predictor.dtype).removeprefix("torch."),
                      "buckets": list(service.buckets),
                      "resolution": list(predictor.resolution)}), flush=True)
    try:
        httpd.serve_forever()
    finally:
        service.stop()
        httpd.server_close()
        print(json.dumps({"stopped": True,
                          "stats": service.metrics.snapshot()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
