"""The port's serving engine on the CPU (``device="cpu"``).

Twin of tests/test_serving.py for ``medt_tpu_torch.serving``: fixed-shape
batching, micro-batching, priority order, backpressure, on-device uint8
normalization, and masks equal to ``logits_to_foreground`` of the model's
logits — the port's decode checked against the JAX package's.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu.metrics import logits_to_foreground as jax_foreground
from medt_tpu_torch.evaluation import sliding_window_inference
from medt_tpu_torch.metrics import logits_to_foreground
from medt_tpu_torch.models import build_model
from medt_tpu_torch.serving import InferenceEngine, QueueFullError

SIZE = 32
BATCH = 4


@pytest.fixture(scope="module")
def variables():
    return build_model("axialunet", img_size=SIZE, seed=0,
                       device="cpu").state_dict()


@pytest.fixture(scope="module")
def engine(variables):
    eng = InferenceEngine("axialunet", SIZE, variables=variables,
                          batch_size=BATCH, max_wait_ms=20.0, device="cpu")
    yield eng
    eng.stop()


def _img(seed):
    return np.random.default_rng(seed).integers(
        0, 255, size=(SIZE, SIZE, 3)).astype(np.uint8)


@pytest.mark.parametrize("mode", ["threshold", "argmax"])
def test_decode_matches_jax(mode):
    logits = np.random.default_rng(0).normal(
        scale=0.5, size=(3, 2, 8, 8)).astype(np.float32)
    want = jax_foreground(jnp.asarray(logits.transpose(0, 2, 3, 1)),
                          mode=mode)
    got = logits_to_foreground(torch.from_numpy(logits), mode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_masks_are_the_decoded_model_logits(engine):
    imgs = [_img(i) for i in range(BATCH + 2)]  # a full batch + a partial
    masks = engine.predict_batch(imgs)
    assert len(masks) == len(imgs)
    x = torch.from_numpy(np.stack(imgs)).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        logits = engine.model(x)
    want = logits_to_foreground(logits).numpy().astype(np.uint8)
    for m, w in zip(masks, want):
        assert m.shape == (SIZE, SIZE) and m.dtype == np.uint8
        np.testing.assert_array_equal(m, w)
    # a padded partial batch scores like the same image alone
    np.testing.assert_array_equal(engine.predict_batch([imgs[-1]])[0],
                                  masks[-1])


def test_uint8_is_normalized_on_the_device(engine):
    img = _img(7)
    np.testing.assert_array_equal(
        engine.predict_batch([img])[0],
        engine.predict_batch([img.astype(np.float32) / 255.0])[0])


def test_shapes_the_engine_does_not_take(engine):
    """Batches take imgsize images only; ``predict`` sends a larger or a
    smaller image through the sliding window (it raised for both before
    the window was ported) and refuses a wrong channel count."""
    with pytest.raises(ValueError):
        engine.predict_batch([np.zeros((SIZE * 2, SIZE, 3), np.uint8)])
    with pytest.raises(ValueError):
        engine.predict(np.zeros((SIZE * 2, SIZE * 2, 1), np.uint8))
    rng = np.random.default_rng(9)
    for shape in ((SIZE * 2, SIZE + 9), (SIZE - 7, SIZE + 5)):
        img = rng.integers(0, 255, size=shape + (3,)).astype(np.uint8)
        mask = engine.predict(img)
        assert mask.shape == shape and mask.dtype == np.uint8
        with torch.no_grad():
            logits = sliding_window_inference(
                img.astype(np.float32) / 255.0, engine.model, SIZE,
                batch_size=BATCH, device="cpu")
        want = logits_to_foreground(logits[None])[0].numpy()
        np.testing.assert_array_equal(mask, want.astype(np.uint8))
    assert engine.predict(_img(8)).shape == (SIZE, SIZE)


def test_dynamic_batching_coalesces(engine):
    engine.start()
    before = engine.batches_run
    imgs = [_img(i) for i in range(BATCH)]
    futs = [engine.submit(im) for im in imgs]
    results = [f.result(timeout=60) for f in futs]
    for got, want in zip(results, engine.predict_batch(imgs)):
        np.testing.assert_array_equal(got, want)
    # 4 concurrent submits did not run as 4 separate batches (+1: the
    # reference predict_batch above)
    assert engine.batches_run - before <= 4
    assert engine.stats()["latency_ms"]["count"] >= BATCH


def _parked_engine(variables, **kw):
    """An engine whose worker parks inside its first batch until released,
    so the queue behind it is frozen and its drain order deterministic."""
    eng = InferenceEngine("axialunet", SIZE, variables=variables,
                          batch_size=2, max_wait_ms=1.0, device="cpu", **kw)
    release, parked = threading.Event(), threading.Event()
    real = eng.predict_batch

    def gated(images):
        parked.set()
        assert release.wait(timeout=60)
        return real(images)

    eng.predict_batch = gated
    eng.start()
    return eng, release, parked


def test_priority_queue_order(variables):
    """A high-priority submit overtakes a queued low-priority backlog."""
    eng, release, parked = _parked_engine(variables)
    try:
        order = []

        def track(tag):
            return lambda fut: order.append(tag)

        eng.submit(_img(0)).add_done_callback(track("blocker"))
        assert parked.wait(timeout=60)
        for i in range(4):
            eng.submit(_img(i + 1), priority=5).add_done_callback(
                track(f"low{i}"))
        hi = eng.submit(_img(9), priority=0)
        hi.add_done_callback(track("hi"))
        release.set()
        hi.result(timeout=60)
        assert order[0] == "blocker" and order[1] == "hi"
    finally:
        release.set()
        eng.stop()


def test_queue_full_backpressure(variables):
    eng, release, parked = _parked_engine(variables, max_queue=2)
    try:
        first = eng.submit(_img(0))
        assert parked.wait(timeout=60)
        queued = [eng.submit(_img(1)), eng.submit(_img(2))]
        with pytest.raises(QueueFullError):
            eng.submit(_img(3))
        release.set()
        for f in [first] + queued:
            assert f.result(timeout=60).shape == (SIZE, SIZE)
    finally:
        release.set()
        eng.stop()


def test_engine_needs_variables():
    with pytest.raises(ValueError):
        InferenceEngine("axialunet", SIZE, device="cpu")


def test_gray_engine_takes_one_channel():
    """``gray=True`` builds the model with one input channel (JAX
    ``engine.py:77, 94``) and takes (S, S) or (S, S, 1) images."""
    sd = build_model("axialunet", img_size=SIZE, imgchan=1, seed=0,
                     device="cpu").state_dict()
    eng = InferenceEngine("axialunet", SIZE, variables=sd, batch_size=2,
                          gray=True, device="cpu")
    assert eng.model.conv1.weight.shape[1] == 1
    img = np.random.default_rng(3).integers(0, 255, (SIZE, SIZE),
                                            dtype=np.uint8)
    mask = eng.predict(img)
    np.testing.assert_array_equal(mask, eng.predict_batch([img[..., None]])[0])
    with torch.no_grad():
        logits = eng.model(torch.from_numpy(img).float()[None, None] / 255.0)
    np.testing.assert_array_equal(
        mask, logits_to_foreground(logits)[0].numpy().astype(np.uint8))
    assert eng.predict(np.zeros((SIZE + 3, SIZE - 5), np.uint8)).shape == (
        SIZE + 3, SIZE - 5)
    with pytest.raises(ValueError):
        eng.predict_batch([np.zeros((SIZE, SIZE, 3), np.uint8)])
