"""Serve CLI: an HTTP segmentation endpoint over the batched engine.

Port of ``medt_tpu/cli/serve.py``, standard library only:

    python -m medt_tpu_torch.cli.serve --modelname MedT --imgsize 128 \\
        --loaddirec ./results/final_model --port 8900 --batch_size 16

``--dp N`` serves from N replicas on ``cuda:0..N-1``, each batch split
over them (JAX's ``--dp``: each compiled batch sharded over N devices);
``--batch_size`` must divide by N.

Endpoints:
  POST /predict   body = an image of any size (PNG, or any format PIL
                  opens); the model's size rides the
                  engine's micro-batches, any other size goes through the
                  sliding window; response = a PNG mask (0/255), 200.
                  Optional ``X-Priority: <int>`` header: lower is served
                  first (default 0).
  GET  /healthz   ``{"status": "ok", ...engine counters...}``

Other paths answer 404; a full queue (``QueueFullError``) 503 with
``Retry-After: 1``; any other failure 400 with its message.

JAX decodes the body with PIL. For a PNG body the port uses its own PNG
codec (:mod:`..data.png`) and gives the arrays PIL does: a colour PNG as
RGB (alpha dropped, as JAX drops an RGBA image's fourth channel), a gray
PNG as an (H, W) array, which a 3-channel engine refuses (400) as JAX's
does. A gray PNG with alpha reads as gray (PIL gives two channels there).
A palette PNG answers 400: PIL gives its (H, W) palette indices, which
JAX's 3-channel engine refuses and a gray one would read as gray levels.
Any other body (BMP, JPEG, TIFF, ...) goes through PIL as in JAX, imported
at the first such request.
"""
from __future__ import annotations

import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..config import parse_config
from ..data.png import SIGNATURE, decode_png, encode_png
from ..parallel import data_devices
from ..serving import InferenceEngine, QueueFullError

_GRAY_TYPES = (0, 4)  # PNG colour types gray and gray + alpha
_PALETTE = 3


def _decode_with_pil(body: bytes) -> np.ndarray:
    """A non-PNG body as JAX's ``do_POST`` reads it: PIL's array, alpha
    dropped."""
    try:
        from PIL import Image
    except ImportError:
        raise ImportError("a non-PNG request body needs PIL, which does "
                          "not import; send a PNG") from None
    img = np.asarray(Image.open(io.BytesIO(body)))
    return img[..., :3] if img.ndim == 3 and img.shape[-1] == 4 else img


def decode_request_png(body: bytes) -> np.ndarray:
    """A request body -> (H, W) uint8 for a gray image, else (H, W, 3) RGB:
    PNG bodies by the port's codec, any other format by PIL."""
    if not body.startswith(SIGNATURE):
        return _decode_with_pil(body)
    if len(body) < 26:
        raise ValueError("truncated PNG body")
    if body[25] == _PALETTE:                  # IHDR's colour type byte
        raise ValueError("palette PNGs are not served; send RGB or gray")
    if body[25] in _GRAY_TYPES:
        return decode_png(body, gray=True)
    return np.ascontiguousarray(decode_png(body)[..., ::-1])  # BGR -> RGB


def make_handler(engine: InferenceEngine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; counters via /healthz
            pass

        def _reply(self, code: int, body: bytes, content_type=None,
                   headers=()):
            self.send_response(code)
            if content_type:
                self.send_header("Content-Type", content_type)
            for key, value in headers:
                self.send_header(key, value)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            body = json.dumps({"status": "ok", **engine.stats()}).encode()
            self._reply(200, body, "application/json")

        def do_POST(self):
            if self.path != "/predict":
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                img = decode_request_png(self.rfile.read(n))
                s = engine.imgsize
                if img.shape[:2] == (s, s):
                    prio = int(self.headers.get("X-Priority", 0))
                    mask = engine.submit(img, priority=prio).result()
                else:
                    mask = engine.predict(img)  # sliding window
                body = encode_png((mask * 255).astype(np.uint8))
                self._reply(200, body, "image/png")
            except QueueFullError as e:  # backpressure: retry later
                self._reply(503, str(e).encode(),
                            headers=[("Retry-After", "1")])
            except Exception as e:  # report the failure, keep serving
                self._reply(400, str(e).encode()[:1000])

    return Handler


class Server(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog of 128 connections.
    The standard library's backlog of 5 drops the connection attempts of
    more concurrent clients than that, and each one dropped waits for the
    client's SYN retry, a whole second (JAX's server keeps that default)."""

    request_queue_size = 128


def make_server(engine: InferenceEngine, port: int, host: str = "127.0.0.1"):
    """Start the engine's worker and build the HTTP server (port 0: any
    free port, ``server.server_address`` says which); the caller runs
    ``serve_forever``."""
    engine.start()
    return Server((host, port), make_handler(engine))


def main(argv=None, device=None):
    cfg = parse_config(argv, description="medt_tpu_torch serve",
                       device=device)
    if not cfg.loaddirec:
        raise SystemExit("--loaddirec is required")
    if (cfg.tp or 1) > 1:
        raise SystemExit(f"--tp {cfg.tp}: the model axis splits a training "
                         "run (cli.train); cli.serve serves whole replicas "
                         "(--dp)")
    dp = cfg.dp or 1
    engine = InferenceEngine(
        cfg.modelname, cfg.imgsize, loaddirec=cfg.loaddirec,
        batch_size=cfg.batch_size, gray=cfg.gray == "yes",
        use_fused=cfg.use_fused, decision=cfg.pred_mode, device=device,
        devices=data_devices(dp, device) if dp > 1 else None)
    engine.warmup()
    server = make_server(engine, cfg.port)
    print(f"serving {cfg.modelname}@{cfg.imgsize} on :{cfg.port} "
          f"(batch {cfg.batch_size}" + (f", dp={dp}" if dp > 1 else "")
          + ")", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.stop()


if __name__ == "__main__":
    main()
