"""The port's HTTP front, engine options and best-checkpoint sweep against
the JAX package, on the CPU.

* ``cli.serve.make_server`` on port 0 over a CPU engine (axialunet 32 px,
  batch 2, sliding-window stride 16) beside JAX's ``make_server`` over its
  engine, from the same carried weights (JAX on its plain path: its
  interpret-mode Pallas would compile for most of this file's time, and
  tests/test_torch_port_eval.py and the zoo tests hold the fused routes;
  the port on its fused route, plain cores on the CPU). A 32x32 POST (the micro-batch
  route) and a 48x40 POST (overlapping windows) give the masks of JAX's
  responses at every pixel whose JAX decision value (the channel-1 logit,
  thresholded at 0.5) lies more than 1e-4 from the threshold; at least 99%
  of the pixels are such. ``/healthz`` answers the keys JAX's does; both
  answer 404 on other paths, 400 on a body that is no image and on a gray
  or a palette PNG to a 3-channel engine, and 503 with ``Retry-After: 1`` when the
  queue is full; an RGBA PNG serves as its RGB image. The port's server
  listens with a backlog of 128 (JAX's keeps the standard library's 5).
  BMP, JPEG and TIFF bodies written by cv2 decode as JAX's PIL read does
  and serve JAX's masks.
* Engine options: ``loaddirec`` takes a checkpoint of the port's
  ``save_checkpoint`` and a reference-format ``.pth`` (``module.``
  prefix, dead keys) and serves what ``variables`` serves;
  ``window_stride`` gives JAX's engine ``predict`` masks at the same
  stride (56x44 image, stride 16), under the same margin rule.
* ``evaluation.sweep`` against JAX's ``sweep_checkpoint_grid`` (which reads
  with ``cv2.imread(path, 0)``): three epoch directories of gray masks and
  one whose names match no label (nan over 0 images), thresholds 127 and
  130, ``empty_score_one`` on and off, and once with colour (RGB) label
  PNGs: ``per_epoch`` and ``best_epoch`` equal at 1e-6; the CLIs' ``main``
  print the same JSON; the port's gray read of a colour PNG equals
  ``cv2.imread(path, 0)`` on 1024 x 1024 random pixels.
"""
import io
import json
import math
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu.cli import serve as jax_serve
from medt_tpu.evaluation import sweep as jax_sweep
from medt_tpu.evaluation.sliding_window import (
    sliding_window_inference as jax_window)
from medt_tpu.serving import InferenceEngine as JaxEngine
from medt_tpu_torch.cli import serve
from medt_tpu_torch.data.png import decode_png, encode_png, write_png
from medt_tpu_torch.evaluation import sweep
from medt_tpu_torch.serving import InferenceEngine
from medt_tpu_torch.training import save_checkpoint
from test_torch_port_models import carried, jax_variables

SIZE, BATCH, STRIDE = 32, 2, 16
MARGIN = 1e-4
NAME = "axialunet"


@pytest.fixture(scope="module")
def weights():
    variables = jax_variables(NAME, SIZE, seed=5)
    return variables, carried(NAME, variables)


@pytest.fixture(scope="module")
def engines(weights):
    variables, sd = weights
    jeng = JaxEngine(NAME, SIZE, variables=variables, batch_size=BATCH,
                     window_stride=STRIDE, max_wait_ms=20.0,
                     use_fused=False)
    eng = InferenceEngine(NAME, SIZE, variables=sd, batch_size=BATCH,
                          window_stride=STRIDE, max_wait_ms=20.0,
                          device="cpu")
    yield jeng, eng
    jeng.stop()
    eng.stop()


def _server(make_server, engine):
    server = make_server(engine, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join()


def _request(port, path, body=None, headers=None):
    """(status, headers, body) of one request; errors included."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _image(seed, h, w, c=3):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, c),
                                                dtype=np.uint8)


def _jax_decision(jeng, image):
    """JAX's channel-1 logits for an (H, W, 3) uint8 image, by the route its
    engine takes for that size."""
    v = jeng._variables
    x = jnp.asarray(image.astype(np.float32) / np.float32(255.0))
    if image.shape[:2] == (SIZE, SIZE):
        logits = jeng._forward(v, x[None])[0]
    else:
        logits = jax_window(x, lambda xb: jeng._forward(v, xb), window=SIZE,
                            stride=STRIDE, batch_size=BATCH)
    return np.asarray(logits)[..., 1]


def _assert_masks_agree(got, want, decision):
    assert got.shape == want.shape == decision.shape
    clear = np.abs(decision - 0.5) > MARGIN
    assert clear.mean() >= 0.99
    np.testing.assert_array_equal(got[clear], want[clear])


def test_http_masks_match_jax(engines):
    jeng, eng = engines
    servers = [_server(jax_serve.make_server, jeng),
               _server(serve.make_server, eng)]
    # a listen backlog for more concurrent clients than the standard
    # library's 5 (JAX's server keeps 5)
    assert servers[1][0].request_queue_size == 128
    try:
        ports = [s.server_address[1] for s, _ in servers]
        for seed, (h, w), prio in ((11, (SIZE, SIZE), "3"),
                                   (12, (48, 40), "0")):
            image = _image(seed, h, w)
            body = encode_png(image)
            masks = []
            for port in ports:
                status, headers, out = _request(
                    port, "/predict", body, {"X-Priority": prio})
                assert status == 200 and headers["Content-Type"] == \
                    "image/png", (status, out)
                masks.append(decode_png(out, gray=True))
            want, got = masks
            assert set(np.unique(got)) <= {0, 255}
            _assert_masks_agree(got, want, _jax_decision(jeng, image))
        # an RGBA PNG serves as its RGB image
        rgb = _image(11, SIZE, SIZE)
        rgba = np.concatenate([rgb, _image(13, SIZE, SIZE, 1)], axis=-1)
        status, _, out = _request(ports[1], "/predict",
                                  _encode_rgba(rgba))
        assert status == 200
        np.testing.assert_array_equal(decode_png(out, gray=True),
                                      eng.predict_batch([rgb])[0] * 255)

        healths = [json.loads(_request(p, "/healthz")[2]) for p in ports]
        assert healths[1]["status"] == "ok"
        assert set(healths[1]) == set(healths[0])
        assert set(healths[1]["latency_ms"]) == set(healths[0]["latency_ms"])
        for port in ports:
            assert _request(port, "/nowhere")[0] == 404
            assert _request(port, "/predict/x", b"\x00")[0] == 404
            status, _, msg = _request(port, "/predict", b"not a png")
            assert status == 400 and msg
            gray = encode_png(_image(14, SIZE, SIZE, 1)[..., 0])
            assert _request(port, "/predict", gray)[0] == 400
            palette = _encode_palette(_image(15, SIZE, SIZE))
            assert _request(port, "/predict", palette)[0] == 400
    finally:
        for s, t in servers:
            _stop(s, t)


@pytest.mark.parametrize("ext", ["bmp", "jpg", "tiff"])
def test_http_reads_other_formats_as_jax(engines, ext):
    """A BMP, JPEG or TIFF body written by cv2: both fronts decode it with
    PIL (``decode_request_png`` gives JAX's array) and answer the masks of
    JAX's, under the margin rule."""
    cv2 = pytest.importorskip("cv2", reason="cv2 writes the bodies")
    from PIL import Image
    jeng, eng = engines
    ok, buf = cv2.imencode(f".{ext}", _image(16, SIZE, SIZE))
    assert ok
    body = buf.tobytes()
    image = np.asarray(Image.open(io.BytesIO(body)))
    np.testing.assert_array_equal(serve.decode_request_png(body), image)
    servers = [_server(jax_serve.make_server, jeng),
               _server(serve.make_server, eng)]
    try:
        masks = []
        for s, _ in servers:
            status, _, out = _request(s.server_address[1], "/predict", body)
            assert status == 200, out
            masks.append(decode_png(out, gray=True))
        want, got = masks
        _assert_masks_agree(got, want, _jax_decision(jeng, image))
    finally:
        for s, t in servers:
            _stop(s, t)


def _encode_palette(rgb):
    """A palette PNG (colour type 3) of ``rgb``, written by PIL."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb, "RGB").convert("P").save(buf, format="PNG")
    data = buf.getvalue()
    assert data[25] == 3
    return data


def _encode_rgba(rgba):
    """An 8-bit RGBA PNG (colour type 6) of ``rgba``, written by PIL."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgba, "RGBA").save(buf, format="PNG")
    return buf.getvalue()


def test_http_backpressure_answers_503(weights):
    variables, sd = weights
    full = [JaxEngine(NAME, SIZE, variables=variables, batch_size=BATCH,
                      max_queue=0),
            InferenceEngine(NAME, SIZE, variables=sd, batch_size=BATCH,
                            max_queue=0, device="cpu")]
    servers = [_server(jax_serve.make_server, full[0]),
               _server(serve.make_server, full[1])]
    try:
        body = encode_png(_image(15, SIZE, SIZE))
        for server, _ in servers:
            status, headers, msg = _request(server.server_address[1],
                                            "/predict", body)
            assert status == 503 and headers["Retry-After"] == "1"
            assert b"capacity" in msg
    finally:
        for (s, t), eng in zip(servers, full):
            _stop(s, t)
            eng.stop()


def test_engine_loaddirec_and_window_stride(engines, weights, tmp_path):
    jeng, eng = engines
    _, sd = weights
    images = [_image(20 + i, SIZE, SIZE) for i in range(3)]
    want = eng.predict_batch(images)

    model = eng.model
    save_checkpoint(str(tmp_path / "ckpt"), 0, model)
    reference = {f"module.{k}": v for k, v in sd.items()}
    reference["module.bn1.num_batches_tracked"] = torch.tensor(7)
    torch.save(reference, str(tmp_path / "reference.pth"))
    for path in (tmp_path / "ckpt" / "final_model",
                 tmp_path / "ckpt" / "0" / "ckpt.pth",
                 tmp_path / "reference.pth"):
        loaded = InferenceEngine(NAME, SIZE, loaddirec=str(path),
                                 batch_size=BATCH, device="cpu")
        for k, v in loaded.model.state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
        for g, w in zip(loaded.predict_batch(images), want):
            np.testing.assert_array_equal(g, w)

    image = _image(30, 56, 44)
    got = eng.predict(image)
    assert got.dtype == np.uint8 and got.shape == (56, 44)
    _assert_masks_agree(got, jeng.predict(image), _jax_decision(jeng, image))


# ---- the sweep ---------------------------------------------------------------

def _sweep_tree(root, rgb_labels):
    """Labels and three epoch dirs of masks (0/255), plus an epoch dir whose
    names match no label."""
    rng = np.random.default_rng(40)
    names = [f"{i:03d}.png" for i in range(5)]
    labels = root / "labelcol"
    labels.mkdir()
    for n in names:
        if rgb_labels:
            write_png(str(labels / n), rng.integers(0, 256, size=(24, 20, 3),
                                                    dtype=np.uint8))
        else:
            lab = (rng.uniform(size=(24, 20)) < 0.4) * 255
            lab[0, 0] = 129   # between the two thresholds
            write_png(str(labels / n), lab.astype(np.uint8))
    preds = root / "preds"
    for ep, p_fg in ((0, 0.2), (1, 0.5), (2, 0.7)):
        d = preds / str(ep)
        d.mkdir(parents=True)
        for i, n in enumerate(names):
            mask = rng.uniform(size=(24, 20)) < p_fg
            if i == 0:
                mask[:] = False           # an empty prediction
            img = mask.astype(np.uint8) * 255
            img[1, 1] = 128               # between the two thresholds
            write_png(str(d / n), img)
    (preds / "3").mkdir()
    write_png(str(preds / "3" / "other.png"), np.zeros((24, 20), np.uint8))
    return str(preds), str(labels)


def _same_sweep(got, want):
    assert got["best_epoch"] == want["best_epoch"]
    assert set(got["per_epoch"]) == set(want["per_epoch"])
    for ep, w in want["per_epoch"].items():
        g = got["per_epoch"][ep]
        assert g["images"] == w["images"]
        for k in ("f1", "miou", "pa"):
            if math.isnan(w[k]):
                assert math.isnan(g[k]), (ep, k)
            else:
                assert abs(g[k] - w[k]) <= 1e-6, (ep, k, g[k], w[k])


@pytest.mark.parametrize("rgb_labels", [False, True])
def test_sweep_matches_jax(tmp_path, rgb_labels):
    pred_root, label_dir = _sweep_tree(tmp_path, rgb_labels)
    for thresh in (127, 130):
        for empty in (False, True):
            kw = dict(pred_thresh=thresh, gt_thresh=thresh,
                      empty_score_one=empty)
            want = jax_sweep.sweep_checkpoint_grid(pred_root, label_dir, **kw)
            got = sweep.sweep_checkpoint_grid(pred_root, label_dir,
                                              device="cpu", **kw)
            assert got["per_epoch"][3]["images"] == 0
            assert want["best_epoch"] in (0, 1, 2)
            _same_sweep(got, want)


def test_sweep_cli_prints_jax_json(tmp_path, capsys):
    pred_root, label_dir = _sweep_tree(tmp_path, False)
    argv = ["--pred_root", pred_root, "--label_dir", label_dir,
            "--pred_thresh", "130", "--gt_thresh", "130", "--empty_score_one"]
    jax_sweep.main(argv)
    want = json.loads(capsys.readouterr().out)
    sweep.main(argv, device="cpu")
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(want) == {"per_epoch", "best_epoch", "best"}
    _same_sweep(got, want)
    assert got["best"] == pytest.approx(want["best"], abs=1e-6)


def test_rgb_labels_read_as_cv2_reads_them(tmp_path):
    """The sweep's colour labels: the port's fixed-point ``rgb_to_gray``
    against ``cv2.imread(path, 0)``, which JAX's sweep reads with, on
    1024 x 1024 random RGB pixels."""
    import cv2

    from medt_tpu_torch.data.png import read_png

    path = str(tmp_path / "rgb.png")
    write_png(path, np.random.default_rng(41).integers(
        0, 256, size=(1024, 1024, 3), dtype=np.uint8))
    np.testing.assert_array_equal(read_png(path, gray=True),
                                  cv2.imread(path, 0))
