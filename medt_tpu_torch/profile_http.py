"""The HTTP front's client latency and rate, listen backlog 5 against 128.

    python -m medt_tpu_torch.profile_http [--requests 512] [--clients 8] \\
        [--order 5,128,128,5] [--model MedT --img 128 --batch 16]

Serves the model (seeded random weights) through ``InferenceEngine`` and
``cli.serve``'s handler, and times one window of ``--requests`` POSTs of
128x128 PNGs for each entry of ``--order``: a listen backlog of 5 is the
standard library's ``ThreadingHTTPServer`` as it comes, 128 is
``cli.serve.Server``. The clients are ``--clients`` threads in a child
process, each opening a connection per request at two ``X-Priority``
values, so the server's process holds the GIL alone. A warm-up window
(uncounted) goes first. Prints one JSON object: per window the requests/s,
client latency p50/p90/p99/max (request to the response's last byte,
nearest rank), the connect time's p99 and max, the requests over one
second and the engine's forwards. Exits non-zero if a status is not 200.
Needs a card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import http.client
import json
import math
import multiprocessing
import sys
import threading
import time


def _post(port: int, body: bytes, priority: int):
    """(status, connect seconds, total seconds) of one POST /predict."""
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.connect()
        t1 = time.perf_counter()
        conn.request("POST", "/predict", body,
                     {"X-Priority": str(priority),
                      "Content-Type": "image/png"})
        resp = conn.getresponse()
        resp.read()
        status = resp.status
    finally:
        conn.close()
    return status, t1 - t0, time.perf_counter() - t0


def _clients(pipe, bodies, clients: int):
    """Child process: for each ``(port, n)`` received, ``n`` POSTs from
    ``clients`` threads; sends back the results and the window's seconds.
    ``None`` ends it."""
    while True:
        job = pipe.recv()
        if job is None:
            return
        port, n = job
        out = [None] * n

        def run(k):
            for i in range(k, n, clients):
                out[i] = _post(port, bodies[i % len(bodies)],
                               0 if i % 3 else 5)

        threads = [threading.Thread(target=run, args=(k,))
                   for k in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        pipe.send((out, time.perf_counter() - t0))


def _rank(sorted_ms, q):
    return sorted_ms[max(0, math.ceil(q * len(sorted_ms)) - 1)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="MedT")
    parser.add_argument("--img", type=int, default=128)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--requests", type=int, default=512)
    parser.add_argument("--clients", type=int, default=8)
    parser.add_argument("--order", default="5,128,128,5",
                        help="listen backlogs, one timed window each")
    parser.add_argument("--device", default=None,
                        help="default: the card; 'cpu' for a dry run")
    args = parser.parse_args(argv)
    order = [int(b) for b in args.order.split(",")]
    import numpy as np
    import torch

    if args.device is None and not torch.cuda.is_available():
        print("profile_http: no CUDA device", file=sys.stderr)
        return 2
    from http.server import ThreadingHTTPServer

    from .cli.serve import Server, make_handler
    from .data.png import encode_png
    from .models import build_model
    from .serving import InferenceEngine

    servers = {5: ThreadingHTTPServer, 128: Server}
    for b in order:
        if b not in servers or servers[b].request_queue_size != b:
            raise SystemExit(f"profile_http: no server with backlog {b}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    variables = build_model(args.model, img_size=args.img, seed=0,
                            device="cpu").state_dict()
    engine = InferenceEngine(args.model, args.img, variables=variables,
                             batch_size=args.batch, device=args.device)
    engine.warmup()
    engine.start()
    rng = np.random.default_rng(0)
    bodies = [encode_png(rng.integers(0, 256, size=(args.img, args.img, 3),
                                      dtype=np.uint8)) for _ in range(32)]
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_clients, args=(child, bodies, args.clients),
                       daemon=True)
    proc.start()
    windows, bad = [], []
    try:
        for label, backlog, n in ([("warm-up", order[0], 64)]
                                  + [(f"window {i}", b, args.requests)
                                     for i, b in enumerate(order)]):
            server = servers[backlog](("127.0.0.1", 0), make_handler(engine))
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            batches0 = engine.batches_run
            try:
                parent.send((server.server_address[1], n))
                out, seconds = parent.recv()
            finally:
                server.shutdown()
                server.server_close()
                thread.join()
            bad += [(label, s) for s, _, _ in out if s != 200]
            if label == "warm-up":
                continue
            total = sorted(t * 1e3 for _, _, t in out)
            connect = sorted(c * 1e3 for _, c, _ in out)
            windows.append({
                "backlog": backlog, "requests": n,
                "requests_per_s": n / seconds,
                "client_p50_ms": _rank(total, 0.50),
                "client_p90_ms": _rank(total, 0.90),
                "client_p99_ms": _rank(total, 0.99),
                "client_max_ms": total[-1],
                "connect_p99_ms": _rank(connect, 0.99),
                "connect_max_ms": connect[-1],
                "over_1s": sum(t >= 1000.0 for t in total),
                "forwards": engine.batches_run - batches0})
    finally:
        parent.send(None)
        proc.join(timeout=30)
        if proc.is_alive():
            proc.terminate()
            proc.join()
        engine.stop()
    print(json.dumps({
        "device": (torch.cuda.get_device_name(0) if args.device is None
                   else args.device),
        "model": args.model, "img": args.img, "batch": args.batch,
        "clients": args.clients, "windows": windows,
        "bad_statuses": bad[:20]}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
