"""Serve CLI — a batching HTTP inference daemon over the one serving step
(letterbox -> forward -> decode -> NMS -> source-pixel boxes), port of
``modelcompression_tpu/cli/serve.py``.

Requests are decoded and letterboxed on host threads, then gathered into
fixed-size device batches by a single dispatch thread, so the card sees
only batch-``B`` runs of one step. Runs on ``--device cuda`` (default) or
``--device cpu``; a missing CUDA device is an error. Serves any bundled
family ([region] YOLOv2, [yolo] YOLOv3 / YOLOv4) from f32 ``.weights``,
an int8 ``--qmodel`` artifact (of either package; served through
``compress.forward_quantized``), a weight-sharing ``--cmodel`` artifact
(its reconstructed float32 params), or a random model from seed 0 when
none is given, with every serving NMS flag of the JAX CLI
(``--diou-nms`` / ``--diou-beta`` default to the cfg's
``nms_kind=diounms`` / ``beta_nms``). ``--dp N`` serves data-parallel:
the params replicated on N devices of --device, every batch split over
them, one step per shard (``parallel.data_parallel``).

Endpoints:
  POST /detect     image file bytes (jpeg/png/bmp) -> JSON detections in
                   source-image pixel coordinates
  GET  /healthz    liveness + model info
  GET  /stats      request/batch counters, mean batch fill, throughput
  GET  /metrics    the /stats counters in Prometheus text format

Example:
  python -m modelcompression_tpu_torch.cli.serve \
      --cfg modelcompression_tpu_torch/configs/yolov2-voc.cfg \
      --weights yolov2.weights --deployment --batch 64 --port 8000
  curl -s --data-binary @dog.jpg localhost:8000/detect
"""

from __future__ import annotations

import argparse
import collections
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from modelcompression_tpu_torch.cli.common import (
    add_model_args, add_serving_nms_args, build_mesh, dispatch_padded_batch,
    fetch_batch, load_serving_model, prepare_serving,
    resolve_serving_eval_config, run_padded_batch, unpack_detections,
)
from modelcompression_tpu_torch.data.preprocess import letterbox_host
from modelcompression_tpu_torch.data.voc import VOC_CLASSES, read_names
from modelcompression_tpu_torch.evaluation import make_eval_step
from modelcompression_tpu_torch.parallel import data_parallel, replicate

MAX_BODY = 64 * 1024 * 1024


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p, weights_required=False)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device the serving step runs on (default cuda; "
                        "a missing CUDA device is an error)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch", type=int, default=16,
                   help="device batch size (requests are gathered up to "
                        "this many per dispatch)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="how long the dispatcher waits to fill a batch "
                        "after the first request arrives")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel serving: split each device batch "
                        "over this many devices on a 'data' mesh axis "
                        "(params replicated, one step per shard). --batch "
                        "must divide evenly. 0 = single device (default)")
    add_serving_nms_args(p)
    p.add_argument("--names", default=None, help=".names file")
    p.add_argument("--qmodel", default=None, metavar="PATH",
                   help="serve a saved int8 deployment artifact "
                        "(eval --int8 --save-qmodel) instead of --weights")
    p.add_argument("--cmodel", default=None, metavar="PATH",
                   help="serve a saved weight-sharing artifact "
                        "(eval --cluster-bits N --save-cmodel) instead "
                        "of --weights")
    p.add_argument("--timeout-s", type=float, default=60.0,
                   help="per-request wait bound for a batch slot")
    p.add_argument("--verbose", action="store_true",
                   help="per-request access log on stderr")
    return p


class _Pending:
    __slots__ = ("canvas", "w", "h", "event", "result", "error",
                 "abandoned", "t_submit")

    def __init__(self, canvas, w, h):
        self.canvas = canvas
        self.w = w
        self.h = h
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.abandoned = False  # set by a waiter that already timed out
        self.t_submit = time.monotonic()


class ServeState:
    """Model + batcher shared by the HTTP handlers and the dispatcher."""

    def __init__(self, spec, params, step, names, args, mesh=None):
        self.spec = spec
        self.mesh = mesh
        self.params = params
        self.step = step
        self.names = names
        self.cfg = None  # resolved EvalConfig, set by build_server
        self.batch = max(1, args.batch)
        self.max_wait = max(0.0, args.max_wait_ms) / 1e3
        self.timeout_s = args.timeout_s
        self.verbose = args.verbose
        # bounded queue = backpressure: a burst beyond device throughput
        # gets an immediate 503 instead of piling up canvases
        self.q: "queue.Queue[_Pending]" = queue.Queue(
            maxsize=max(4 * self.batch, 16))
        self.stop = threading.Event()
        self.lock = threading.Lock()
        self.n_requests = 0
        self.n_images = 0
        self.n_batches = 0
        self.n_rejected = 0
        self.n_overlapped = 0  # batches dispatched while one was in flight
        self.latencies_ms = collections.deque(maxlen=4096)
        self.t_start = time.monotonic()

    def submit(self, canvas, w, h) -> Optional[_Pending]:
        """Enqueue for the next batch; None = queue full (the caller sends
        503 at once)."""
        item = _Pending(canvas, w, h)
        with self.lock:
            self.n_requests += 1
        try:
            self.q.put_nowait(item)
        except queue.Full:
            with self.lock:
                self.n_rejected += 1
            return None
        return item

    def _gather(self, first_timeout: float):
        """Collect up to one batch: wait up to ``first_timeout`` for the
        first request, then up to max_wait to fill. Waiters that already
        timed out are dropped."""
        try:
            first = self.q.get(timeout=first_timeout) if first_timeout > 0 \
                else self.q.get_nowait()
        except queue.Empty:
            return []
        items = [first]
        deadline = time.monotonic() + self.max_wait
        while len(items) < self.batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                items.append(self.q.get(timeout=left))
            except queue.Empty:
                break
        return [it for it in items if not it.abandoned]

    def _fail(self, items, e: Exception) -> None:
        for it in items:
            it.error = f"inference failed: {e!r}"
            it.event.set()

    def _dispatch(self, items):
        """Enqueue one padded batch on the device; on failure fail its
        waiters and return None."""
        try:
            return dispatch_padded_batch(
                self.step, self.params, [it.canvas for it in items],
                [it.w for it in items], [it.h for it in items], self.batch)
        except Exception as e:  # the dispatcher thread must keep running
            self._fail(items, e)
            return None

    def _distribute(self, items, dev):
        """Fetch one dispatched batch's results and wake its waiters."""
        try:
            sel, sc, valid = fetch_batch(dev)
        except Exception as e:  # surface the failure to every waiter
            self._fail(items, e)
            return
        now = time.monotonic()
        for j, it in enumerate(items):
            dets = unpack_detections(sel[j], sc[j], valid[j], it.w, it.h)
            for d in dets:
                d["name"] = self.names[d["class_id"]]
            it.result = dets
            it.event.set()
        with self.lock:
            self.n_images += len(items)
            self.n_batches += 1
            self.latencies_ms.extend(
                (now - it.t_submit) * 1e3 for it in items)

    def dispatch_loop(self):
        """Single thread owning the device: gather -> pad -> dispatch ->
        distribute, pipelined: while batch i runs on the device, batch
        i+1 is gathered and enqueued, and only then are batch i's results
        fetched. When the queue is idle the loop is the serial path.
        Runs until ``stop`` is set."""
        pending = None  # (items, device outputs) in flight
        while not self.stop.is_set():
            if pending is None:
                items = self._gather(first_timeout=0.1)
                if not items:
                    continue
                dev = self._dispatch(items)
                pending = (items, dev) if dev is not None else None
            else:
                items = self._gather(first_timeout=0.0)
                nxt = None
                if items:
                    dev = self._dispatch(items)
                    if dev is not None:
                        nxt = (items, dev)
                        with self.lock:
                            self.n_overlapped += 1
                self._distribute(*pending)
                pending = nxt
        if pending is not None:  # shutdown: don't strand waiters
            self._distribute(*pending)

    def metrics_text(self) -> str:
        """Prometheus text exposition (v0.0.4) of the /stats counters."""
        s = self.stats()
        rows = [
            ("requests_total", "counter", s["requests"],
             "HTTP /detect requests accepted"),
            ("images_total", "counter", s["images"],
             "images inferred (completed batches)"),
            ("batches_total", "counter", s["batches"],
             "device batches dispatched and fetched"),
            ("rejected_total", "counter", s["rejected"],
             "requests rejected by queue backpressure (503)"),
            ("overlapped_batches_total", "counter", s["overlapped_batches"],
             "batches dispatched while a previous batch was in flight"),
            ("queue_depth", "gauge", s["queue_depth"],
             "requests waiting for a dispatch slot"),
            ("latency_ms_p50", "gauge", s["latency_ms_p50"],
             "p50 submit-to-result latency over the sliding window (ms)"),
            ("latency_ms_p99", "gauge", s["latency_ms_p99"],
             "p99 submit-to-result latency over the sliding window (ms)"),
            ("mean_batch_fill", "gauge", s["mean_batch_fill"],
             "mean images per dispatched batch"),
            ("compiled_batch", "gauge", s["compiled_batch"],
             "device batch size"),
            ("uptime_seconds", "gauge", s["uptime_s"],
             "seconds since server start"),
            ("images_per_second_wall", "gauge", s["img_per_sec_wall"],
             "lifetime wall-clock image throughput"),
        ]
        out = []
        for name, typ, val, help_ in rows:
            full = f"mc_torch_serve_{name}"
            out.append(f"# HELP {full} {help_}")
            out.append(f"# TYPE {full} {typ}")
            out.append(f"{full} {val}")
        return "\n".join(out) + "\n"

    def stats(self) -> dict:
        with self.lock:
            wall = time.monotonic() - self.t_start
            lats = sorted(self.latencies_ms)

            def pct(p):  # nearest-rank percentile over the window
                if not lats:
                    return 0.0
                return round(lats[min(len(lats) - 1,
                                      int(p / 100.0 * len(lats)))], 2)

            return {
                "requests": self.n_requests,
                "images": self.n_images,
                "batches": self.n_batches,
                "rejected": self.n_rejected,
                "overlapped_batches": self.n_overlapped,
                "queue_depth": self.q.qsize(),
                "latency_ms_p50": pct(50),
                "latency_ms_p99": pct(99),
                "latency_window": len(lats),
                "mean_batch_fill": (self.n_images / self.n_batches
                                    if self.n_batches else 0.0),
                "compiled_batch": self.batch,
                "dp": self.mesh.shape["data"] if self.mesh else 1,
                "uptime_s": round(wall, 1),
                "img_per_sec_wall": (self.n_images / wall
                                     if wall > 0 else 0.0),
            }


def _make_handler(state: ServeState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):
            if state.verbose:
                sys.stderr.write("%s - %s\n" % (self.address_string(),
                                                fmt % a))

        def _send_json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self.close_connection:  # early-return paths: body unread
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                cfg = state.cfg
                self._send_json(200, {
                    "ok": True,
                    "classes": state.spec.classes,
                    "net": [state.spec.net.height, state.spec.net.width],
                    "batch": state.batch,
                    "device": cfg.device if cfg else None,
                    "conf": cfg.conf_thresh if cfg else None,
                    "max_detections": cfg.max_detections if cfg else None,
                    "nms_prefilter": cfg.nms_prefilter if cfg else None,
                    "dp": (state.mesh.shape["data"]
                           if state.mesh is not None else 1),
                })
            elif self.path == "/stats":
                self._send_json(200, state.stats())
            elif self.path == "/metrics":
                body = state.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send_json(404, {"error": "not found"})

        def do_POST(self):
            if self.path.split("?")[0] != "/detect":
                # body unread: close so a keep-alive client's next request
                # is not parsed out of the leftover bytes
                self.close_connection = True
                self._send_json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                n = 0
            if n <= 0 or n > MAX_BODY:
                self.close_connection = True
                self._send_json(400, {"error": "bad Content-Length"})
                return
            body = self.rfile.read(n)
            import cv2
            img = cv2.imdecode(np.frombuffer(body, np.uint8),
                               cv2.IMREAD_COLOR)
            if img is None:
                self._send_json(400, {"error": "cannot decode image"})
                return
            h, w = img.shape[:2]
            canvas, _, _, _ = letterbox_host(
                img[:, :, ::-1], state.spec.net.height,
                state.spec.net.width)
            item = state.submit(canvas, float(w), float(h))
            if item is None:
                self._send_json(503, {"error": "server overloaded"})
                return
            if not item.event.wait(state.timeout_s):
                item.abandoned = True
                self._send_json(503, {"error": "inference timed out"})
                return
            if item.error is not None:
                self._send_json(500, {"error": item.error})
                return
            self._send_json(200, {"width": w, "height": h,
                                  "detections": item.result})

    return Handler


def build_server(args) -> "tuple[ThreadingHTTPServer, ServeState]":
    """Load the model, run one warm-up batch, and return (httpd, state)
    with the dispatcher ALREADY running — callers only
    serve_forever()/shutdown()."""
    spec, params, quantized = load_serving_model(args)
    names = read_names(args.names) if args.names else list(VOC_CLASSES)
    if len(names) != spec.classes:
        names = [f"class{i}" for i in range(spec.classes)]
    cfg = resolve_serving_eval_config(args, spec=spec)
    folded, cfg = prepare_serving(spec, params, quantized, cfg)
    step = make_eval_step(spec, cfg)
    mesh = None
    dp = getattr(args, "dp", 0)
    if dp >= 1:
        # the params replicated on a 'data' mesh, every device batch split
        # over it in the step (same mechanism as eval --dp)
        if args.batch % dp:
            raise ValueError(
                f"--batch {args.batch} must be divisible by --dp {dp}")
        mesh, _ = build_mesh(args)
        folded = replicate(folded, mesh)
        step = data_parallel(step, mesh)
    state = ServeState(spec, folded, step, names, args, mesh=mesh)
    state.cfg = cfg

    # warm-up through the dispatcher's exact call path (first-call costs:
    # cuDNN algorithm selection, kernel build and load)
    t0 = time.monotonic()
    dummy = np.zeros((spec.net.height, spec.net.width, 3), np.uint8)
    run_padded_batch(step, folded, [dummy], [float(spec.net.width)],
                     [float(spec.net.height)], state.batch)
    print(f"warmed up the batch-{state.batch} serving step on {cfg.device} "
          f"in {time.monotonic() - t0:.1f}s", file=sys.stderr)

    httpd = ThreadingHTTPServer((args.host, args.port),
                                _make_handler(state))
    worker = threading.Thread(target=state.dispatch_loop,
                              name="mc-torch-dispatch", daemon=True)
    worker.start()
    return httpd, state


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if sum(map(bool, (args.weights, args.qmodel, args.cmodel))) > 1:
        print("error: at most one of --weights, --qmodel or --cmodel may "
              "be given", file=sys.stderr)
        return 2
    if args.batch < 1:
        print("error: --batch must be >= 1", file=sys.stderr)
        return 2
    if not (args.weights or args.qmodel or args.cmodel):
        print("note: no --weights given; serving a random model (seed 0)",
              file=sys.stderr)
    try:
        httpd, state = build_server(args)
    except (ValueError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port}  "
          f"(device {state.cfg.device}, batch {state.batch}, wait "
          f"{state.max_wait * 1e3:.0f} ms, conf {state.cfg.conf_thresh}, "
          f"K {state.cfg.max_detections}, prefilter "
          f"{state.cfg.nms_prefilter}"
          f"{', deployment preset' if args.deployment else ''}"
          + (f", dp {state.mesh.shape['data']}"
             if state.mesh is not None else "") + ")",
          file=sys.stderr)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        state.stop.set()
        httpd.server_close()
        print(json.dumps(state.stats()), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
