"""The port's ImageFolder data path against the JAX package and cv2, on
CPU.

* ``resize_linear`` equals ``cv2.resize(..., INTER_LINEAR)`` on uint8 bit
  for bit (no residue) over up- and down-scales, exact 2x downscales,
  tiny sizes, gray and RGB images;
* ``ImageFolderDataset`` gives JAX's items for a seed (which reads and
  resizes with cv2 here) in train and eval mode, equal to float32
  rounding of the normalisation, with the same labels and names;
* a PNG item imports neither cv2 nor PIL; a JPEG reads through cv2, and
  through PIL where cv2 does not import, each equal to that library's
  own decode; with neither, a non-PNG read raises an ImportError naming
  the format.
"""
import pathlib
import _torch_threads  # noqa: F401  (one PyTorch thread)
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from medt_tpu.data.imagenet import ImageFolderDataset as JaxImageFolder
from medt_tpu_torch.data import imagenet
from medt_tpu_torch.data.png import write_png

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")


def write_image_folder(root, per_class=3, size=(40, 48), classes=("cat",
                                                                  "dog"),
                       seed=0):
    """<root>/<class>/<i>.png, random RGB images of ``size`` (h, w)."""
    rng = np.random.default_rng(seed)
    for c in classes:
        d = root / c
        d.mkdir(parents=True, exist_ok=True)
        for i in range(per_class):
            write_png(str(d / f"{i}.png"), rng.integers(
                0, 256, (*size, 3), dtype=np.uint8))
    return str(root)


@pytest.mark.parametrize("gray", [False, True])
def test_resize_linear_equals_cv2(gray):
    rng = np.random.default_rng(1 + gray)
    sizes = [(1, 1), (2, 3), (5, 7), (37, 53), (64, 64), (97, 131),
             (256, 256), (300, 200)]
    targets = [(1, 1), (4, 4), (13, 11), (32, 32), (112, 112), (224, 224),
               (292, 292)]
    n = 0
    for (H, W) in sizes:
        img = rng.integers(0, 256, (H, W) if gray else (H, W, 3),
                           dtype=np.uint8)
        for (h, w) in targets + [(max(H // 2, 1), max(W // 2, 1))]:
            want = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
            got = imagenet.resize_linear(img, (h, w))
            assert got.dtype == np.uint8 and got.shape == want.shape
            assert np.array_equal(got, want), ((H, W), (h, w))
            n += 1
    assert n == len(sizes) * (len(targets) + 1)


@pytest.mark.parametrize("train", [True, False])
def test_image_folder_items_equal_jax(tmp_path, train):
    root = write_image_folder(tmp_path, per_class=3, size=(57, 83))
    port = imagenet.ImageFolderDataset(root, img_size=24, train=train)
    ref = JaxImageFolder(root, img_size=24, train=train)
    assert port.classes == ref.classes and port.samples == ref.samples
    for idx in range(len(port)):
        got = port.__getitem__(idx, rng=np.random.default_rng(idx))
        want = ref.__getitem__(idx, rng=np.random.default_rng(idx))
        assert got[0].shape == want[0].shape == (24, 24, 3)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
        assert got[1] == want[1] and got[2] == want[2]
    sharded = imagenet.ImageFolderDataset(root, 24, train=train,
                                          shard=(1, 4))
    assert sharded.samples == port.samples[1::4]


def test_reads_png_alone_then_jpeg_through_cv2_then_pil(tmp_path):
    """A PNG item imports neither cv2 nor PIL; a JPEG reads through cv2
    (the port's item is JAX's, both reading with cv2), then, in a process
    where cv2 does not import, through PIL (equal to PIL's own decode
    through the port's crop and resize), and where neither imports it
    raises an ImportError naming the format."""
    root = write_image_folder(tmp_path / "png", per_class=1)
    (tmp_path / "jpg" / "a").mkdir(parents=True)
    path = tmp_path / "jpg" / "a" / "x.jpg"
    cv2.imwrite(str(path), np.random.default_rng(5).integers(
        0, 256, (30, 40, 3), dtype=np.uint8))
    jpg = str(tmp_path / "jpg")
    np.testing.assert_allclose(
        imagenet.ImageFolderDataset(jpg, 28, train=False)[0][0],
        JaxImageFolder(jpg, 28, train=False)[0][0], atol=1e-6)
    code = f"""
        import sys
        import numpy as np
        from medt_tpu_torch.data.imagenet import (IMAGENET_MEAN,
                                                  IMAGENET_STD,
                                                  ImageFolderDataset,
                                                  center_crop)
        img, label, name = ImageFolderDataset({root!r}, 16, train=True)[0]
        assert img.shape == (16, 16, 3)
        print(sorted(m for m in ("cv2", "PIL") if m in sys.modules))
        sys.modules["cv2"] = None
        img, _, _ = ImageFolderDataset({jpg!r}, 28, train=False)[0]
        from PIL import Image
        rgb = np.asarray(Image.open({str(path)!r}).convert("RGB"))
        want = (center_crop(rgb, 28).astype(np.float32) / 255.0
                - IMAGENET_MEAN) / IMAGENET_STD
        print(float(np.abs(img - want).max()))
        sys.modules["PIL"] = None
        try:
            ImageFolderDataset({jpg!r}, 28, train=False)[0]
        except ImportError as e:
            print(e)
    """
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=str(pathlib.Path(__file__).parent.parent),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    imported, err, message = proc.stdout.strip().split("\n", 2)
    assert imported == "[]"
    assert float(err) <= 1e-6
    assert ".jpg" in message and "cv2 or PIL" in message
