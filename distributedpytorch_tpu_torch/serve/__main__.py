"""HTTP front: ``python -m distributedpytorch_tpu_torch.serve``.

A stdlib ``http.server`` shell around :class:`service.InferenceService`;
each request thread submits into the shared queue and blocks on its future.

    POST /v1/predict   {"image": <wire array>, "points": [[x, y]] * 4,
                        "deadline_ms": optional, "session_id": optional}
                    -> {"mask": <wire array>, "latency_ms": ...}
                       429 shed (queue full; with "code": "session_lane"
                       when one session's lane is full) | 504 deadline
                       | 400 bad input | 503 service stopped or no result
                       in time
    GET  /healthz   -> 200 / 503 with the service's health
    GET  /stats     -> the metrics snapshot
    GET  /metrics   -> Prometheus text exposition of the process-wide
                       telemetry registry (the serve counters, span
                       percentiles, goodput gauges when co-hosted)
    POST /debug/trace?steps=N
                    -> arm a bounded on-demand ``torch.profiler`` capture
                       of the next N batches (202 + target dir; 409 when
                       one is already armed or active; 503 when the
                       service has none).  SIGUSR2 arms the same default
                       capture.  Traces land under ``--trace-dir``.

The model is DANet with random weights from a seed (``--fresh-init
SIZE:BACKBONE:SEED[:INJECT]``, INJECT ``stem`` or ``head``), a saved
``state_dict`` of the port's DANet (``--state-dict PTH``), or a training run of the port (``--run-dir RUN``, its best
checkpoint, or ``--step N``).  A ``guidance_inject=head`` model serves
sessions: a request's ``session_id`` keeps its crop's features on the
card (``--session-budget-mb``, ``--session-ttl-s``), and one session holds
at most ``--session-lane-depth`` queued requests.  It runs on CUDA unless
``--device cpu``, in float32 with TF32 off, or in the run's precision with
``--run-dir`` (a bf16 run serves in bf16 on its float32 weights).
``--quantize int8`` serves int8 conv weights (``serve/quantize.py``); without
the flag a ``--run-dir`` run's ``model.quantization`` decides, and
``--quantize none`` serves float weights whatever the run says.  The boot
line's ``quantization`` is the policy's block, or null.  ``--warmup``
readies every bucket's program before the server listens; with
``--aot-cache DIR`` it loads them from the AOT cache
(``python -m distributedpytorch_tpu_torch.serve.aot``, ``serve/aot.py``),
warming a missing or refused entry eagerly with a loud stderr line.  The
boot line's ``cold_start`` holds the warm-up's seconds, the programs
warmed eagerly and loaded, and the cache's outcome (``off``, ``hit``,
``partial``, ``miss``), or null without ``--warmup``; a stderr line before
it gives the compiles a ``CompileWatchdog`` counted over the warm-up.
SIGTERM/SIGINT stop the server, fail the queued requests and exit 0.
An ``InjectedFaultError`` from an armed ``serve/enqueue`` fault
(``DPTPU_CHAOS_PLAN``) is not caught, as on the JAX front: that request's
connection closes without a reply, and the server serves on.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..telemetry import prometheus
from ..telemetry.registry import get_registry
from ..telemetry.trace import TraceCapture, query_steps
from .client import decode_array, encode_array
from .service import (
    DeadlineExceededError,
    InferenceService,
    QueueFullError,
    ServiceUnhealthyError,
    SessionLaneFullError,
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
            self._reply_text(code, json.dumps(payload), "application/json")

        def _reply_text(self, code: int, text: str,
                        content_type: str) -> None:
            body = text.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            if code == 429:
                self.send_header("Retry-After", "1")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802 — http.server's contract
            if self.path == "/metrics":
                self._reply_text(200, prometheus.render_text(get_registry()),
                                 prometheus.CONTENT_TYPE)
            elif self.path == "/healthz":
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
            base, _, query = self.path.partition("?")
            if base == "/debug/trace":
                if service.trace is None:
                    self._reply(503, {"error": "trace capture not armed "
                                               "for this service"})
                    return
                target = service.trace.request(query_steps(query))
                if target is None:
                    self._reply(409, {"error": "a trace capture is "
                                               "already armed or active"})
                else:
                    self._reply(202, {"trace_dir": target,
                                      "note": "starts at the next batch; "
                                              "bounded by steps and a "
                                              "wall-clock backstop"})
                return
            if base != "/v1/predict":
                self._reply(404, {"error": f"no such path {self.path!r}"})
                return
            try:
                body = json.loads(raw.decode("utf-8"))
                image = decode_array(body["image"])
                points = np.asarray(body["points"], np.float64)
                deadline_ms = body.get("deadline_ms")
                deadline_s = None if deadline_ms is None \
                    else float(deadline_ms) / 1e3
                # no session_id: the stateless request
                session_id = body.get("session_id")
                if session_id is not None:
                    session_id = str(session_id)
                t0 = time.perf_counter()
                fut = service.submit(image, points, deadline_s=deadline_s,
                                     session_id=session_id)
                mask = fut.result(timeout=request_timeout_s
                                  if deadline_s is None
                                  else min(deadline_s + 5.0, request_timeout_s))
                self._reply(200, {
                    "mask": encode_array(mask),
                    "latency_ms": (time.perf_counter() - t0) * 1e3})
            except SessionLaneFullError as e:
                # a 429 as a full queue, with a code so that the client
                # raises the same type
                self._reply(429, {"error": str(e), "code": "session_lane"})
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


def parse_fresh_spec(spec: str) -> tuple[int, str, int, str]:
    """``SIZE:BACKBONE:SEED[:INJECT]`` -> (size, backbone, seed, inject);
    INJECT is ``stem`` (the default) or ``head``."""
    parts = spec.split(":")
    if len(parts) not in (3, 4) or not (parts[0].isdigit() and parts[2].isdigit()):
        raise SystemExit(f"--fresh-init wants SIZE:BACKBONE:SEED[:INJECT], "
                         f"got {spec!r}")
    inject = parts[3] if len(parts) == 4 else "stem"
    if inject not in ("stem", "head"):
        raise SystemExit(f"--fresh-init: unknown guidance inject {inject!r} "
                         "(stem | head)")
    return int(parts[0]), parts[1], int(parts[2]), inject


def build_predictor(args):
    """The served Predictor from ``--fresh-init``, ``--state-dict`` or
    ``--run-dir``, quantized by ``--quantize`` or, without the flag, by a
    run's ``model.quantization`` (the policy is resolved before any
    weight is read, so an unknown value raises first)."""
    import torch

    from ..models import build_model
    from ..predict import Predictor, load_run_config
    from .quantize import quant_policy, quantize_predictor

    quantize = getattr(args, "quantize", None)
    if args.run_dir and quantize is None:
        quantize = load_run_config(args.run_dir).model.quantization or None
    policy = quant_policy(quantize)
    if args.run_dir:
        predictor = Predictor.from_run(args.run_dir, step=args.step,
                                       device=args.device)
    elif args.fresh_init:
        size, backbone, seed, inject = parse_fresh_spec(args.fresh_init)
        predictor = Predictor.fresh(size, backbone, seed=seed,
                                    device=args.device, guidance_inject=inject)
    else:
        state = torch.load(args.state_dict, map_location="cpu",
                           weights_only=True)
        # a head model's state_dict carries the guidance projection
        model = build_model("danet", nclass=1, backbone=args.backbone,
                            output_stride=8,
                            guidance_inject="head" if "guidance_proj.weight"
                            in state else "stem")
        model.load_state_dict(state, strict=True)
        predictor = Predictor(model,
                              resolution=(args.resolution, args.resolution),
                              device=args.device)
    if policy is not None:
        predictor = quantize_predictor(predictor, policy)
    return predictor


def boot_record(args, predictor, service: InferenceService, port: int) -> dict:
    """The first line the server prints once it listens."""
    from .quantize import quantization_block

    return {"serving": f"http://{args.host}:{port}",
            "device": str(predictor.device),
            "dtype": str(predictor.dtype).removeprefix("torch."),
            "buckets": list(service.buckets),
            "resolution": list(predictor.resolution),
            "sessions": service.sessions_enabled,
            "quantization": quantization_block(predictor.quant_policy),
            "cold_start": cold_start_block(service.last_warmup)}


def cold_start_block(warm: dict | None) -> dict | None:
    """The boot line's ``cold_start``: the warm-up's seconds, programs
    warmed eagerly and loaded, and the cache outcome; null without
    ``--warmup``."""
    if warm is None:
        return None
    return {k: warm[k] for k in ("warmup_seconds", "programs_compiled",
                                 "programs_loaded", "aot_cache")}


def add_model_source_args(parser: argparse.ArgumentParser,
                          required: bool = True) -> None:
    """The served model's flags: its source (``--fresh-init``,
    ``--state-dict`` or ``--run-dir`` with ``--step``), ``--backbone`` and
    ``--resolution`` of a state dict, ``--device`` and ``--quantize``; the
    server's and the AOT cache's command lines share them, and
    :func:`build_predictor` resolves them."""
    src = parser.add_mutually_exclusive_group(required=required)
    src.add_argument("--fresh-init", metavar="SIZE:BACKBONE:SEED",
                     help="serve DANet with random weights drawn from SEED "
                          "at SIZE² (e.g. 512:resnet101:0); a fourth field "
                          "head serves sessions (512:resnet101:0:head)")
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
    parser.add_argument("--quantize", choices=("int8", "none"), default=None,
                        help="int8 weight-only quantization of the served "
                             "model (serve/quantize); default: the run "
                             "config's model.quantization, else none")


def make_parser() -> argparse.ArgumentParser:
    """The server's command line."""
    parser = argparse.ArgumentParser(
        prog="distributedpytorch_tpu_torch.serve",
        description="Batched click-to-mask inference over HTTP (PyTorch/CUDA)")
    add_model_source_args(parser)
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
                        help="ready every bucket's program before taking "
                             "traffic (eagerly, or from --aot-cache)")
    parser.add_argument("--aot-cache", metavar="DIR", default=None,
                        help="with --warmup, load the bucket ladder's AOT "
                             "packages from DIR (python -m "
                             "distributedpytorch_tpu_torch.serve.aot); a "
                             "missing or bad entry warms eagerly, loudly. "
                             "It boots slower than the eager warm-up and "
                             "serves no faster, and each package holds its "
                             "own copy of the weights on the card, outside "
                             "the allocator's accounting (README)")
    parser.add_argument("--session-budget-mb", type=float, default=256.0,
                        help="device byte budget of the session feature "
                             "cache (split predictors only); LRU evicts "
                             "past it")
    parser.add_argument("--session-ttl-s", type=float, default=600.0,
                        help="idle seconds before a session's cached "
                             "features are reaped")
    parser.add_argument("--session-lane-depth", type=int, default=4,
                        help="queued requests one session may hold (more "
                             "shed with 429, code session_lane)")
    parser.add_argument("--trace-dir", default=None,
                        help="where POST /debug/trace and SIGUSR2 write "
                             "bounded profiler captures (default: "
                             "<run-dir>/serve_trace, or ./serve_trace)")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = make_parser().parse_args(argv)

    predictor = build_predictor(args)
    trace = TraceCapture(args.trace_dir or os.path.join(
        args.run_dir or ".", "serve_trace"))
    service = InferenceService(
        predictor, max_batch=args.max_batch, queue_depth=args.queue_depth,
        max_wait_s=args.max_wait_ms / 1e3,
        default_deadline_s=None if args.deadline_ms is None
        else args.deadline_ms / 1e3, trace=trace,
        session_budget_bytes=int(args.session_budget_mb * 2**20),
        session_ttl_s=args.session_ttl_s,
        session_lane_depth=args.session_lane_depth,
        aot_cache=args.aot_cache)
    if args.warmup:
        from ..utils.compile_watchdog import CompileWatchdog

        with CompileWatchdog() as wd:
            service.warmup()
        print(f"serve/warmup: {wd.total} compiles on the CompileWatchdog "
              f"{dict(wd.counts)}", file=sys.stderr, flush=True)
    service.start()
    httpd = make_server(service, args.host, args.port)

    def on_signal(signum, frame):
        # shutdown() must come from another thread than serve_forever's
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    # SIGUSR2 arms the same bounded capture POST /debug/trace does
    uninstall_trace_signal = trace.install_signal()
    print(json.dumps(boot_record(args, predictor, service,
                                 httpd.server_port)), flush=True)
    try:
        httpd.serve_forever()
    finally:
        service.stop()
        httpd.server_close()
        uninstall_trace_signal()
        print(json.dumps({"stopped": True,
                          "stats": service.metrics.snapshot()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
