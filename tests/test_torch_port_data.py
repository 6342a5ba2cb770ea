"""The port's data layer, metrics, window, checkpoints and config on the CPU.

* ``data/png.py`` (numpy + zlib) is bit-exact with the JAX package's libpng
  decoder (``medt_tpu.data.native.decode_image``) on gray, RGB, RGBA,
  gray + alpha, palette + tRNS, 16-bit and 1-bit files, read as colour and
  as gray, and on all five row filters; its encoder's files decode the
  same through libpng. Fixtures are written with PIL.
* Transforms, datasets and loader batches equal the JAX package's, sample
  for sample, on a ``make_png_dataset`` set (the JAX colour jitter is held
  to its numpy chain, the port's only one).
* Metrics, ``sliding_window_inference`` (atol 1e-5), checkpoints (a round
  trip, and a reference ``.pth`` with ``module.`` prefixes and dead keys),
  the config and the logging helpers.
"""
import dataclasses
import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medt_tpu import metrics as jmetrics
from medt_tpu.config import parse_config as jax_parse_config
from medt_tpu.data import DataLoader as JaxLoader
from medt_tpu.data import Image2D as JaxImage2D
from medt_tpu.data import ImageToImage2D as JaxDataset
from medt_tpu.data import JointTransform2D as JaxTransform
from medt_tpu.data import native
from medt_tpu.data.synthetic import make_png_dataset as jax_make_png_dataset
from medt_tpu.evaluation.sliding_window import (
    sliding_window_inference as jax_window)
from medt_tpu.utils import Logger as JaxLogger
from medt_tpu_torch import metrics
from medt_tpu_torch.config import parse_config
from medt_tpu_torch.data import (DataLoader, Image2D, ImageToImage2D,
                                 JointTransform2D, make_png_dataset, png,
                                 to_device)
from medt_tpu_torch.evaluation import sliding_window_inference, window_grid
from medt_tpu_torch.models import build_model
from medt_tpu_torch.training import (adam_l2, restore_checkpoint,
                                     save_checkpoint)
from medt_tpu_torch.utils import Logger, ThroughputMeter, chk_mkdir


@pytest.fixture
def libpng():
    if not native.available():
        pytest.skip("the JAX package's libpng decoder (native/) is not built "
                    "here: nothing to hold the port's decoder against")
    return native


@pytest.fixture
def pil():
    return pytest.importorskip("PIL.Image",
                               reason="PIL writes the PNG fixtures")


def _fixture(pil, kind, rng, h=23, w=37):
    """A PIL image of ``kind`` and the save options it needs."""
    u8 = lambda *s: rng.integers(0, 256, size=s, dtype=np.uint8)  # noqa
    if kind == "gray":
        return pil.fromarray(u8(h, w), "L"), {}
    if kind == "rgb":
        return pil.fromarray(u8(h, w, 3), "RGB"), {}
    if kind == "rgba":
        return pil.fromarray(u8(h, w, 4), "RGBA"), {}
    if kind == "gray_alpha":
        return pil.fromarray(u8(h, w, 2), "LA"), {}
    if kind == "palette_trns":
        im = pil.fromarray(rng.integers(0, 16, size=(h, w), dtype=np.uint8),
                           "P")
        im.putpalette(u8(16 * 3).tolist())
        return im, {"transparency": bytes(u8(16))}
    if kind == "gray16":
        im = pil.new("I;16", (w, h))
        im.frombytes(rng.integers(0, 65536, size=(h, w))
                     .astype("<u2").tobytes())
        return im, {}
    if kind == "bit1":
        return pil.fromarray(rng.integers(0, 2, size=(h, w)).astype(bool)), {}
    raise KeyError(kind)


KINDS = ["gray", "rgb", "rgba", "gray_alpha", "palette_trns", "gray16",
         "bit1"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("gray", [False, True])
def test_png_decode_is_bit_exact_with_libpng(tmp_path, libpng, pil, kind,
                                             gray):
    im, opts = _fixture(pil, kind, np.random.default_rng(KINDS.index(kind)))
    path = str(tmp_path / f"{kind}.png")
    im.save(path, **opts)
    want = libpng.decode_image(path, gray=gray)
    got = png.read_png(path, gray=gray)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _filtered_png(image, depth, ctype, filters):
    """PNG bytes whose row y is written with filter ``filters[y % len]``
    (the encoder side of none, sub, up, average and paeth)."""
    h = image.shape[0]
    rows = image.reshape(h, -1).astype(np.int64)
    bpp = max(1, image.shape[-1] * depth // 8)
    out, prior = [], np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        kind, x = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if kind == 0:
            f = x
        elif kind == 1:
            f = x - left
        elif kind == 2:
            f = x - prior
        elif kind == 3:
            f = x - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            f = x - np.where((pa <= pb) & (pa <= pc), left,
                             np.where(pb <= pc, prior, upleft))
        out.append(bytes([kind]) + (f % 256).astype(np.uint8).tobytes())
        prior = x
    header = struct.pack(">IIBBBBB", image.shape[1], h, depth, ctype, 0, 0,
                         0)
    return (png.SIGNATURE + png._chunk(b"IHDR", header)
            + png._chunk(b"IDAT", zlib.compress(b"".join(out)))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,ctype,channels", [
    (8, 2, 3), (8, 0, 1), (16, 2, 3), (16, 6, 4)])
def test_png_all_five_filters_and_16bit_colour(tmp_path, libpng, depth,
                                               ctype, channels):
    """Every filter type, row after row (and 16-bit colour, which PIL does
    not write), against libpng, read as colour and as gray."""
    rng = np.random.default_rng(depth + ctype)
    hi = 65536 if depth == 16 else 256
    image = rng.integers(0, hi, size=(15, 21, channels))
    if depth == 16:
        image = image.astype(">u2").view(np.uint8).reshape(15, 21, -1)
    data = _filtered_png(image.astype(np.uint8), depth, ctype,
                         [0, 1, 2, 3, 4, 4, 3, 1])
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(data)
    for gray in (False, True):
        np.testing.assert_array_equal(png.decode_png(data, gray),
                                      libpng.decode_image(path, gray=gray))


def test_png_interlaced_raises():
    header = struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 1)
    data = (png.SIGNATURE + png._chunk(b"IHDR", header)
            + png._chunk(b"IDAT", zlib.compress(b"\0" * 20))
            + png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="interlaced"):
        png.decode_png(data)
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"GIF89a" + data)


@pytest.mark.parametrize("shape", [(19, 23), (19, 23, 3)])
def test_png_encoder_decodes_identically_through_libpng(tmp_path, libpng,
                                                        shape):
    image = np.random.default_rng(3).integers(0, 256, size=shape,
                                              dtype=np.uint8)
    path = str(tmp_path / "e.png")
    png.write_png(path, image)
    for gray in (False, True):
        np.testing.assert_array_equal(png.read_png(path, gray),
                                      libpng.decode_image(path, gray=gray))
    want = image if image.ndim == 2 else image[..., ::-1]
    assert np.array_equal(png.read_png(path, gray=image.ndim == 2), want)
    mask = (image if image.ndim == 2 else image[..., 0]) > 127
    png.write_mask_png(path, mask)
    np.testing.assert_array_equal(libpng.decode_image(path, gray=True),
                                  mask.astype(np.uint8) * 255)


# ---- transforms, datasets, loader -------------------------------------------

@pytest.fixture(scope="module")
def png_sets(tmp_path_factory):
    """The same blob set written by JAX (PIL) and by the port (png.py),
    colour and gray."""
    root = tmp_path_factory.mktemp("sets")
    out = {}
    for gray in (False, True):
        tag = "gray" if gray else "rgb"
        out[("jax", gray)] = jax_make_png_dataset(
            str(root / f"jax_{tag}"), n=7, img_size=48, gray=gray, seed=4)
        out[("port", gray)] = make_png_dataset(
            str(root / f"port_{tag}"), n=7, img_size=48, gray=gray, seed=4)
    return out


@pytest.fixture
def numpy_jitter(monkeypatch):
    """The JAX transforms on their numpy colour jitter (the port's only
    one) instead of the native library's."""
    monkeypatch.setattr(native, "jitter_available", lambda: False)


TRANSFORMS = [
    dict(crop=(32, 32), p_flip=0.5, color_jitter_params=(0.1, 0.1, 0.1, 0.1),
         long_mask=True),
    dict(crop=(24, 40), p_flip=0.5, color_jitter_params=None,
         p_random_affine=0.5, long_mask=True),
    dict(crop=None, p_flip=0.0, color_jitter_params=(0.3, 0.2, 0.4, 0.1),
         long_mask=False),
    dict(crop=None, p_flip=1.0, color_jitter_params=None, long_mask=True,
         output_dtype="uint8"),
]


@pytest.mark.parametrize("kw", TRANSFORMS)
@pytest.mark.parametrize("channels", [3, 1])
def test_transforms_match_jax(numpy_jitter, kw, channels):
    rng = np.random.default_rng(5)
    image = rng.integers(0, 256, size=(48, 48, channels), dtype=np.uint8)
    mask = rng.integers(0, 2, size=(48, 48)).astype(np.uint8)
    for seed in range(6):
        got = JointTransform2D(**kw)(image, mask,
                                     rng=np.random.default_rng(seed))
        want = JaxTransform(**kw)(image, mask, rng=np.random.default_rng(seed))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("gray", [False, True])
def test_datasets_match_jax(png_sets, gray):
    """Decoded, binarised items of the JAX-written set through both
    packages, and the port-written set through the port: all equal."""
    jax_dir, port_dir = png_sets[("jax", gray)], png_sets[("port", gray)]
    want = JaxDataset(jax_dir, gray=gray)
    for directory in (jax_dir, port_dir):
        got = ImageToImage2D(directory, gray=gray)
        assert len(got) == len(want)
        for i in range(len(want)):
            for g, w in zip(got[i], want[i]):
                np.testing.assert_array_equal(g, w)
    for (gi, gn), (wi, wn) in zip(
            (Image2D(port_dir, gray=gray)[i] for i in range(3)),
            (JaxImage2D(jax_dir, gray=gray)[i] for i in range(3))):
        assert gn == wn
        np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("gray,workers", [(False, 2), (True, 0)])
def test_loader_batches_match_jax(png_sets, numpy_jitter, gray, workers):
    kw = dict(crop=(32, 32), p_flip=0.5,
              color_jitter_params=(0.1, 0.1, 0.1, 0.1), p_random_affine=0.3,
              long_mask=True)
    got = DataLoader(ImageToImage2D(png_sets[("port", gray)],
                                    JointTransform2D(**kw), gray=gray),
                     3, shuffle=True, num_workers=workers, seed=11)
    want = JaxLoader(JaxDataset(png_sets[("jax", gray)], JaxTransform(**kw),
                                gray=gray),
                     3, shuffle=True, num_workers=workers, seed=11)
    assert len(got) == len(want) == 3
    for _ in range(2):  # two epochs: the reshuffle and the per-epoch seeds
        g_batches, w_batches = list(got), list(want)
        assert len(g_batches) == len(w_batches) == 3
        for g, w in zip(g_batches, w_batches):
            assert g["name"] == w["name"]
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["label"], w["label"])
    dev = to_device(g_batches[0], "cpu")
    assert torch.equal(dev["image"], torch.from_numpy(g_batches[0]["image"]))
    assert dev["name"] == g_batches[0]["name"]


# ---- metrics ------------------------------------------------------------------

def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    out = rng.normal(size=(3, 3, 9, 11)).astype(np.float32)   # NCHW
    gt = rng.integers(0, 3, size=(3, 9, 11))
    nhwc = jnp.asarray(out.transpose(0, 2, 3, 1))
    t_out, t_gt = torch.from_numpy(out), torch.from_numpy(gt)
    for name in ("classwise_iou", "classwise_f1", "jaccard_index",
                 "f1_score"):
        np.testing.assert_allclose(
            getattr(metrics, name)(t_out, t_gt).numpy(),
            np.asarray(getattr(jmetrics, name)(nhwc, jnp.asarray(gt))),
            rtol=1e-6, atol=1e-7, err_msg=name)
    scores = rng.normal(size=(10, 4)).astype(np.float32)
    target = rng.integers(0, 4, size=10)
    assert float(metrics.accuracy(torch.from_numpy(scores),
                                  torch.from_numpy(target))) == \
        float(jmetrics.accuracy(jnp.asarray(scores), jnp.asarray(target)))
    pred = rng.integers(0, 2, size=(4, 6, 7))
    truth = rng.integers(0, 2, size=(4, 6, 7))
    pred[1] = 0                                  # an image with tp == 0
    for empty in (False, True):
        got = metrics.binary_seg_scores(torch.from_numpy(pred),
                                        torch.from_numpy(truth), empty)
        want = jmetrics.binary_seg_scores(jnp.asarray(pred),
                                          jnp.asarray(truth), empty)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    for mode in ("threshold", "argmax"):
        np.testing.assert_array_equal(
            metrics.logits_to_foreground(t_out, mode=mode).numpy(),
            np.asarray(jmetrics.logits_to_foreground(nhwc, mode=mode)))


# ---- sliding window -------------------------------------------------------------

@pytest.mark.parametrize("shape,window,stride,batch", [
    ((200, 150), 64, 48, 5), ((96, 112), 128, 64, 16), ((40, 50), 128, 64, 4),
])
def test_sliding_window_matches_jax(shape, window, stride, batch):
    """A position-dependent per-pixel model, so overlapping tiles disagree
    and the blend shows; the last two images are reflect-padded up to the
    window (the last by more than its own size)."""
    rng = np.random.default_rng(7)
    image = rng.uniform(size=shape + (3,)).astype(np.float32)
    w = rng.normal(size=(2, 3)).astype(np.float32)
    ramp = rng.normal(size=(window, window, 2)).astype(np.float32)

    def jax_fn(tiles):                          # (B, win, win, C) NHWC
        return jnp.einsum("byxc,kc->byxk", tiles, w) + ramp

    calls = []

    def port_fn(tiles):                         # (B, C, win, win) NCHW
        calls.append(tiles.shape[0])
        return torch.einsum("bcyx,kc->bkyx", tiles, torch.from_numpy(w)) + \
            torch.from_numpy(ramp).permute(2, 0, 1)

    want = np.asarray(jax_window(jnp.asarray(image), jax_fn, window, stride,
                                 batch_size=batch))
    got = sliding_window_inference(image, port_fn, window, stride,
                                   batch_size=batch, device="cpu")
    assert got.shape == (2,) + shape
    np.testing.assert_allclose(got.numpy(), want.transpose(2, 0, 1),
                               atol=1e-5, rtol=0)
    assert set(calls) == {batch}                # fixed batch, zero-padded
    padded = [max(s, window) for s in shape]
    tiles = len(window_grid(padded[0], window, stride)) * len(
        window_grid(padded[1], window, stride))
    assert len(calls) == -(-tiles // batch)


# ---- checkpoints ----------------------------------------------------------------

def test_checkpoint_round_trip(tmp_path):
    model = build_model("gatedaxialunet", img_size=32, seed=1, device="cpu")
    opt = adam_l2(model.parameters(), 1e-3)
    x = torch.rand((2, 3, 32, 32), generator=torch.Generator().manual_seed(0))
    model.train()
    model(x).sum().backward()
    opt.step()
    path = save_checkpoint(str(tmp_path), 3, model, opt, step=7)
    assert path == str(tmp_path / "3" / "ckpt.pth")

    fresh = build_model("gatedaxialunet", img_size=32, seed=2, device="cpu")
    fresh_opt = adam_l2(fresh.parameters(), 1e-3)
    assert restore_checkpoint(str(tmp_path / "final_model"), fresh,
                              fresh_opt) == 7
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    saved, loaded = opt.state_dict(), fresh_opt.state_dict()
    for sid, state in saved["state"].items():
        for k, v in state.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(loaded["state"][sid][k]))


def test_checkpoint_reads_a_reference_pth(tmp_path):
    """A bare reference state dict saved through DataParallel: ``module.``
    prefixes and the keys nothing computes with (BN counters, MedT's
    ``adjust_p`` and the wopos blocks' ``conv1``)."""
    model = build_model("MedT", img_size=128, seed=3, device="cpu")
    sd = {f"module.{k}": v.clone() for k, v in model.state_dict().items()}
    sd["module.bn1.num_batches_tracked"] = torch.tensor(5)
    sd["module.adjust_p.weight"] = torch.zeros(2, 16, 1, 1)
    sd["module.layer1_p.0.hight_block.conv1.weight"] = torch.zeros(3)
    path = str(tmp_path / "reference.pth")
    torch.save(sd, path)
    fresh = build_model("MedT", img_size=128, seed=4, device="cpu")
    assert restore_checkpoint(path, fresh) == 0
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    del sd["module.bn1.weight"]
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="bn1.weight"):
        restore_checkpoint(path, fresh)          # strict
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "missing"), fresh)


# ---- config and logging ------------------------------------------------------------

def test_config_matches_jax():
    argv = ["--val_dataset", "v", "--loaddirec", "l", "-b", "4", "--gray",
            "yes", "--crop", "96", "--wd", "0.01", "--resume", "-j", "3",
            "--use_pallas", "no", "--dp", "1"]
    got, want = parse_config(argv), jax_parse_config(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.imgchan == 1 and got.crop_tuple == (96, 96)
    assert not got.use_fused and parse_config([]).use_fused
    for bad in (["--dp", "8"], ["--tp", "2"], ["--platform", "cpu"],
                ["--dtype", "bfloat16"]):
        with pytest.raises(SystemExit):
            parse_config(bad)


def test_logger_and_meter_match_jax(tmp_path):
    rows = [{"epoch": 0, "loss": 0.5}, {"epoch": 1, "loss": 0.25}]
    for cls, tag in ((Logger, "port"), (JaxLogger, "jax")):
        log = cls(jsonl_path=str(tmp_path / tag / "log.jsonl"))
        for r in rows:
            log.log(r)
        log.to_csv(str(tmp_path / f"{tag}.csv"))
    for name in ("log.jsonl",):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "jax.csv").read_text()
    meter = ThroughputMeter()
    meter.update(4)
    meter.update(4)
    assert meter.imgs_per_sec > 0 and meter.steps_per_sec > 0
    chk_mkdir(str(tmp_path / "a" / "b"), str(tmp_path / "c"))
    assert os.path.isdir(tmp_path / "a" / "b") and os.path.isdir(
        tmp_path / "c")
