"""The port's kernels, their build and its isolation from JAX.

This file imports neither JAX nor the JAX package, so it also runs on the
card's machine (``python -m pytest tests/test_torch_port_cuda.py``). Tests
marked ``cuda`` hold each CUDA kernel against its plain PyTorch version and
skip without a card: the forward kernels at tolerance 1e-4 (float32; the
kernel sums keys in another order, with an online softmax for the flash
kernel), the backward and moments kernels at 1e-4 + 1e-4 * max|plain| per
tensor (their outputs are sums over up to S*L terms), and the backward
kernels give bit-identical results on every run (no atomics).
"""
import ast
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu_torch.kernels import build as kbuild
from medt_tpu_torch.ops import axial_eval, axial_lanes, axial_train, moments
from medt_tpu_torch.ops.attn_core import pack_sim_affine

REPO = pathlib.Path(__file__).resolve().parent.parent


def core_inputs(seed, g, gp, L, S, has_pos, device="cpu"):
    """Tensors of a lanes-family core: qkv, qemb, kemb_t, vemb, aff."""
    rng = np.random.default_rng(seed)
    c = gp // 2

    def t(*shape, scale=1.0):
        x = rng.normal(size=shape).astype(np.float32) * scale
        return torch.from_numpy(x).to(device)

    qkv = t(g, 2 * gp, L, S)
    if has_pos:
        qemb, kemb_t, vemb = t(c, L, L), t(c, L, L), t(gp, L, L)
        a, b = t(3, g, scale=0.5).abs(), t(3, g, scale=0.1)
        aff = pack_sim_affine(g, a, b, "full")
    else:
        qemb = kemb_t = vemb = torch.zeros((0, L, L), device=device)
        a, b = t(g, scale=0.5).abs(), t(g, scale=0.1)
        aff = pack_sim_affine(g, a, b, "wopos")
    return qkv, qemb, kemb_t, vemb, aff


# ---- wrappers and build, on any machine -------------------------------------

def test_kernel_wrappers_reject_cpu_tensors():
    """The wrappers launch on CUDA tensors only; a CPU tensor is refused
    before anything is built (the cores send CPU tensors to the plain
    versions instead)."""
    args = core_inputs(9, g=2, gp=4, L=8, S=128, has_pos=True)
    for fn in (axial_lanes.lanes_attn_fwd, axial_lanes.flash_lanes_fwd,
               axial_lanes.flash2_lanes_fwd):
        before = fn.launches
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
        assert fn.launches == before


def test_backward_and_moment_wrappers_reject_cpu_tensors():
    qkv, qemb, kemb_t, vemb, aff = core_inputs(13, g=2, gp=4, L=8, S=128,
                                               has_pos=True)
    d = torch.zeros((2, 4, 8, 128))
    row = torch.zeros((2, 8, 128))
    calls = [
        (axial_lanes.lanes_attn_bwd, (qkv, qemb, kemb_t, vemb, aff, d, d)),
        (axial_lanes.flash_lanes_bwd,
         (qkv, qemb, kemb_t, vemb, aff, row, row, d, d, d, d)),
        (axial_lanes.flash2_lanes_bwd,
         (qkv, qemb, kemb_t, vemb, aff, row, row, d, d, d, d)),
        (moments.moment_sums_fwd, moment_inputs(13, 2, 4, 8, 128, True)),
        (moments.moment_sums_bwd,
         (*moment_inputs(13, 2, 4, 8, 128, True), torch.zeros(2, 8))),
    ]
    for fn, args in calls:
        before = fn.launches
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
        assert fn.launches == before


def eval_inputs(seed, g, gp, L, S, has_pos, device="cpu"):
    """The eval kernel's operands: q, k, v as views of one stripe-major
    (S, g, 2gp, L) qkv, the tables (zero-size without positions) and the
    (g, 8) and (g, 4, gp) affines."""
    qkv, qemb, kemb_t, vemb, aff = core_inputs(seed, g, gp, L, S, has_pos,
                                               device)
    c = gp // 2
    st = qkv.permute(3, 0, 1, 2).contiguous()
    rng = np.random.default_rng(seed + 1)
    out_aff = torch.from_numpy(rng.uniform(0.5, 1.5, size=(g, 4, gp))
                               .astype(np.float32)).to(device)
    if not has_pos:
        out_aff[:, 2:] = 0.0
    return (st[:, :, :c], st[:, :, c:gp], st[:, :, gp:], qemb, kemb_t, vemb,
            aff, out_aff)


def test_eval_wrapper_rejects_cpu_tensors():
    args = eval_inputs(19, g=2, gp=4, L=8, S=16, has_pos=True)
    before = axial_eval.axial_eval_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        axial_eval.axial_eval_fwd(*args)
    assert axial_eval.axial_eval_fwd.launches == before


def stripe_inputs(seed, g, gp, L, S, has_pos, device="cpu"):
    """The stripe core's operands: dense stripe-major q, k, v, the tables
    (kemb in [c, j, i]; zero-size without positions) and the affine."""
    qkv, qemb, kemb_t, vemb, aff = core_inputs(seed, g, gp, L, S, has_pos,
                                               device)
    c = gp // 2
    st = qkv.permute(3, 0, 1, 2)
    kemb = kemb_t.transpose(1, 2).contiguous() if has_pos else kemb_t
    return (st[:, :, :c].contiguous(), st[:, :, c:gp].contiguous(),
            st[:, :, gp:].contiguous(), qemb, kemb, vemb, aff)


def test_stripe_wrappers_reject_cpu_tensors():
    args = stripe_inputs(22, g=2, gp=4, L=32, S=8, has_pos=True)
    d = torch.zeros((8, 2, 4, 32))
    for fn, extra in ((axial_train.stripe_attn_fwd, ()),
                      (axial_train.stripe_attn_bwd, (d, d))):
        before = fn.launches
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args, *extra)
        assert fn.launches == before


def test_cores_on_cpu_run_the_plain_versions():
    args = core_inputs(11, g=2, gp=4, L=8, S=64, has_pos=True)
    counts = axial_lanes.launch_counts()
    for got, want in zip(axial_lanes.lanes_attn_core(*args),
                         axial_lanes.lanes_attn_plain(*args)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    args = core_inputs(11, g=2, gp=4, L=96, S=64, has_pos=True)
    for got, want in zip(axial_lanes.flash2_lanes_core(*args),
                         axial_lanes.flash2_lanes_plain(*args)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert axial_lanes.launch_counts() == counts
    args = stripe_inputs(11, g=2, gp=4, L=32, S=8, has_pos=True)
    stripe_counts = axial_train.launch_counts()
    from medt_tpu_torch.ops.attn_core import attn_core_plain
    for got, want in zip(axial_train.fused_attn_core(*args),
                         attn_core_plain(*args)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert axial_train.launch_counts() == stripe_counts


def test_build_is_atomic_and_keyed_by_source_hash(tmp_path, monkeypatch):
    """The library appears under its hash name only after nvcc succeeded;
    a second call reuses it; a failed build leaves nothing loadable."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\nimport sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n")
    fake.chmod(0o755)
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(kbuild, "BUILD_DIR", build_dir)
    monkeypatch.setattr(kbuild, "nvcc_path", lambda: str(fake))
    first = kbuild.build()
    assert first.path.name == f"libmedt_kernels-{kbuild.source_hash()}.so"
    assert first.path.read_text() == "lib"
    assert not list(build_dir.glob(".tmp-*"))
    assert kbuild.build().seconds == 0.0

    first.path.unlink()
    fake.write_text(f"#!{sys.executable}\nimport sys\nsys.exit(3)\n")
    with pytest.raises(kbuild.BuildError):
        kbuild.build()
    assert not list(build_dir.iterdir())


def moment_inputs(seed, g, gp, L, S, has_pos, device="cpu"):
    """Tensors of the moments core: qkv, r_q, e_q, r_k, e_k."""
    rng = np.random.default_rng(seed)
    c = gp // 2
    qkv = torch.from_numpy(rng.normal(size=(g, 2 * gp, L, S))
                           .astype(np.float32)).to(device)
    if not has_pos:
        zr, ze = torch.zeros((0, L)), torch.zeros((0, 0, L))
        return [qkv, zr.to(device), ze.to(device), zr.to(device),
                ze.to(device)]
    qemb, kemb = (torch.from_numpy(rng.normal(size=(c, L, L))
                                   .astype(np.float32) / gp).to(device)
                  for _ in range(2))
    tables = (qemb.sum(2), torch.einsum("cij,dij->cdi", qemb, qemb),
              kemb.sum(2), torch.einsum("cji,dji->cdj", kemb, kemb))
    return [qkv] + [t.contiguous() for t in tables]


def test_sources_include_no_torch_header():
    for path in (REPO / "medt_tpu_torch" / "csrc").iterdir():
        text = path.read_text()
        assert "#include <torch" not in text and "ATen" not in text, path


def test_sources_include_headers_that_exist_and_use_every_header():
    """Every ``#include "..."`` in csrc/ names a file there, and every
    header there is included by at least one ``.cu``: a header that no
    source builds is dead code that the build never checks."""
    csrc = REPO / "medt_tpu_torch" / "csrc"
    names = {path.name for path in csrc.iterdir()}
    included_by_cu = set()
    for path in sorted(csrc.iterdir()):
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                               path.read_text(), flags=re.M):
            assert name in names, f"{path.name} includes missing {name}"
            if path.suffix == ".cu":
                included_by_cu.add(name)
    headers = {name for name in names if name.endswith(".cuh")}
    assert headers, "no headers found"
    assert headers <= included_by_cu, sorted(headers - included_by_cu)


# ---- nothing of JAX in the port ---------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "PIL", "cv2",
             "medt_tpu", "torch.utils.cpp_extension")
# the readers of non-PNG images (JAX's cv2/PIL fallbacks): imported inside
# the functions that read such an image, never when a module is imported
# (the card's machine has neither)
LAZY_ONLY = ("PIL", "cv2")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_nothing_of_jax_ast():
    files = sorted((REPO / "medt_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        in_function = {id(sub) for fn in ast.walk(tree)
                       if isinstance(fn, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                       for sub in ast.walk(fn)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Attribute):  # torch.utils.cpp_extension
                names = [node.attr]
            else:
                continue
            lazy = id(node) in in_function and not isinstance(
                node, ast.Attribute)
            bad += [f"{path.relative_to(REPO)}: {n}" for n in names
                    if (_forbidden(n) and not (lazy and n.split(".")[0]
                                               in LAZY_ONLY))
                    or n == "cpp_extension"]
    assert not bad, bad


def test_port_imports_nothing_of_jax_at_runtime():
    """What importing the port loads (beyond what the interpreter had
    loaded before it) holds none of them."""
    code = ("import sys; before = set(sys.modules); "
            "import medt_tpu_torch.serving.engine, medt_tpu_torch.models, "
            "medt_tpu_torch.utils.weights, medt_tpu_torch.cli.test, "
            "medt_tpu_torch.cli.predict, medt_tpu_torch.cli.train, "
            "medt_tpu_torch.training.trainer, medt_tpu_torch.data, "
            "medt_tpu_torch.cli.serve, "
            "medt_tpu_torch.config, medt_tpu_torch.training, "
            "medt_tpu_torch.ops.axial_train, medt_tpu_torch.profile_train; "
            "print(' '.join(sorted(set(sys.modules) - before)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = [m for m in out.stdout.split() if _forbidden(m)]
    assert not loaded, loaded


# ---- on the card: kernels vs their plain versions ---------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,L,gp,has_pos", [
    ("lanes", 8, 4, True), ("lanes", 16, 2, False), ("lanes", 4, 16, False),
    ("lanes", 2, 8, True), ("flash", 32, 4, True), ("flash", 64, 2, True),
    ("flash", 48, 8, False), ("flash", 20, 16, True),
])
def test_kernel_matches_plain_on_card(cuda_device, kernel, L, gp, has_pos):
    """Odd stripe count (a ragged last block) and spans that are not a
    multiple of the key block included."""
    args = core_inputs(10, g=8, gp=gp, L=L, S=300, has_pos=has_pos,
                       device=cuda_device)
    if kernel == "lanes":
        fn, plain = axial_lanes.lanes_attn_fwd, axial_lanes.lanes_attn_plain
    else:
        fn, plain = axial_lanes.flash_lanes_fwd, axial_lanes.flash_lanes_plain
    before = fn.launches
    got = fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    for o, w in zip(got, want):
        torch.testing.assert_close(o, w, atol=1e-4, rtol=1e-4)


# (span, gp, stripes, has_pos): spans that no key step divides, with S =
# 301 (no multiple of 4, so the 16-byte copies are off), both variants; the
# medt_512 site (64, 4, 4096) without positions, at its full width
FLASH_FWD_CARD_GEOMETRIES = [
    (17, 2, 301, True), (33, 4, 301, False), (63, 8, 301, True),
    (17, 16, 301, False), (33, 2, 301, True), (63, 4, 301, True),
    (64, 4, 4096, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("L,gp,S,has_pos", FLASH_FWD_CARD_GEOMETRIES)
def test_flash_forward_matches_plain_on_card(cuda_device, L, gp, S, has_pos):
    """The tiled flash forward: sv, sve at 1e-4, m and l also at rtol
    1e-5, against the plain version; the same bits on a second run; one
    launch counted per call."""
    args = core_inputs(29, g=8, gp=gp, L=L, S=S, has_pos=has_pos,
                       device=cuda_device)
    fn = axial_lanes.flash_lanes_fwd
    before = fn.launches
    got, again = fn(*args), fn(*args)
    want = axial_lanes.flash_lanes_plain(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    for name, o, a, w in zip(("sv", "sve", "m", "l"), got, again, want):
        rtol = 1e-5 if name in ("m", "l") else 0.0
        torch.testing.assert_close(o, w, atol=1e-4, rtol=rtol, msg=name)
        assert torch.equal(o, a), f"{name} differs between two runs"


# (span, gp, stripes, has_pos): every path site of the lanes forward at its
# full width, both variants (MedT 128 at batch 16; medt_512; the MedT 128
# batch-1 sites, where the query rows split into chunks); then S no
# multiple of 4 (4-byte copies) with a ragged last tile, S under one tile,
# spans 1-3, and gp 16 with positions (the largest staging)
LANES_FWD_SITES = [
    (16, 2, 4096), (16, 4, 4096), (8, 4, 2048), (8, 8, 2048), (4, 8, 1024),
    (4, 16, 1024), (16, 8, 1024), (16, 16, 1024), (8, 4, 128), (8, 8, 128),
    (16, 2, 256), (16, 4, 256),
]
LANES_FWD_CARD_GEOMETRIES = [
    (L, gp, S, pos) for L, gp, S in LANES_FWD_SITES for pos in (False, True)
] + [
    (16, 4, 301, False), (12, 8, 301, True), (8, 2, 20, True),
    (16, 16, 7, False), (1, 2, 33, True), (2, 8, 70, False),
    (3, 4, 130, True), (16, 16, 300, True), (5, 16, 64, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("L,gp,S,has_pos", LANES_FWD_CARD_GEOMETRIES)
def test_lanes_forward_matches_plain_on_card(cuda_device, L, gp, S, has_pos):
    """The lanes forward: sv and sve within 1e-4 of the plain version, the
    same bits on a second run, one launch counted per call."""
    args = core_inputs(31, g=8, gp=gp, L=L, S=S, has_pos=has_pos,
                       device=cuda_device)
    fn = axial_lanes.lanes_attn_fwd
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before + 1
    again = fn(*args)
    want = axial_lanes.lanes_attn_plain(*args)
    torch.cuda.synchronize()
    for name, o, a, w in zip(("sv", "sve"), got, again, want):
        torch.testing.assert_close(o, w, atol=1e-4, rtol=1e-4, msg=name)
        assert torch.equal(o, a), f"{name} differs between two runs"


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernel_does_not_take(cuda_device):
    qkv, qemb, kemb_t, vemb, aff = core_inputs(12, g=2, gp=4, L=8, S=128,
                                               has_pos=True,
                                               device=cuda_device)
    fn = axial_lanes.lanes_attn_fwd
    with pytest.raises(TypeError):
        fn(qkv.double(), qemb, kemb_t, vemb, aff)
    with pytest.raises(ValueError, match="contiguous"):
        fn(qkv.transpose(2, 3).contiguous().transpose(2, 3), qemb, kemb_t,
           vemb, aff)
    big = core_inputs(12, g=2, gp=4, L=32, S=128, has_pos=True,
                      device=cuda_device)
    with pytest.raises(ValueError, match="span"):
        fn(*big)


def _close(got, want, name):
    tol = 1e-4 + 1e-4 * float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, atol=tol, rtol=0, msg=name)


def _grads_in(seed, g, gp, L, S, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(g, gp, L, S))
                             .astype(np.float32)).to(device)
            for _ in range(2)]


# (kernel, span, gp, has_pos, stripes): stripe counts ragged for every tile
# (128 stripes a flash row-pass block, 32 a column-pass block, 256 / LP a
# lanes chunk); the path geometries of both kernels, both variants; S below
# one block; with positions, a lanes launch whose blocks walk several
# chunks; lanes spans below their bucket LP (rows past the span idle)
BACKWARD_CARD_GEOMETRIES = [
    ("lanes", 12, 4, True, 300), ("lanes", 5, 2, False, 77),
    ("lanes", 1, 16, False, 33), ("lanes", 3, 8, True, 130),
    ("lanes", 16, 2, False, 300), ("lanes", 4, 16, False, 300),
    ("lanes", 8, 4, True, 300), ("lanes", 16, 16, True, 300),
    ("lanes", 16, 16, False, 300), ("lanes", 4, 8, False, 300),
    ("lanes", 16, 8, True, 9), ("lanes", 16, 2, True, 4301),
    ("flash", 64, 2, True, 300), ("flash", 32, 4, True, 300),
    ("flash", 64, 4, False, 300), ("flash", 20, 8, True, 300),
    ("flash", 64, 4, True, 300), ("flash", 32, 8, False, 300),
    ("flash", 64, 2, False, 300), ("flash", 64, 4, True, 50),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,L,gp,has_pos,S", BACKWARD_CARD_GEOMETRIES)
def test_backward_kernel_matches_plain_on_card(cuda_device, kernel, L, gp,
                                               has_pos, S):
    """The five gradients; a ragged last block; the same bits on a second
    run."""
    args = core_inputs(14, g=8, gp=gp, L=L, S=S, has_pos=has_pos,
                       device=cuda_device)
    dsv, dsve = _grads_in(15, 8, gp, L, S, cuda_device)
    if kernel == "lanes":
        fn, plain = axial_lanes.lanes_attn_bwd, axial_lanes.lanes_attn_bwd_plain
        extra = ()
    else:
        fn = axial_lanes.flash_lanes_bwd
        plain = axial_lanes.flash_lanes_bwd_plain
        sv, sve, m, l = axial_lanes.flash_lanes_fwd(*args)
        extra = (m, l, sv, sve.contiguous())
    before = fn.launches
    got = fn(*args, *extra, dsv, dsve)
    again = fn(*args, *extra, dsv, dsve)
    want = plain(*args, *extra, dsv, dsve)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    for name, o, a, w in zip(("dqkv", "dqemb", "dkemb_t", "dvemb", "daff"),
                             got, again, want):
        _close(o, w, name)
        assert torch.equal(o, a), f"{name} differs between two runs"


@pytest.mark.cuda
@pytest.mark.parametrize("gp,L,has_pos", [
    (2, 64, True), (4, 32, True), (4, 16, False), (16, 4, False),
    (16, 8, True),
])
def test_moment_kernels_match_plain_on_card(cuda_device, gp, L, has_pos):
    ins = moment_inputs(16, 8, gp, L, 300, has_pos, device=cuda_device)
    ct = torch.from_numpy(np.random.default_rng(17).normal(size=(8, 8))
                          .astype(np.float32)).to(cuda_device)
    _close(moments.moment_sums_fwd(*ins), moments.moment_sums_plain(*ins),
           "sums")
    got = moments.moment_sums_bwd(*ins, ct)
    again = moments.moment_sums_bwd(*ins, ct)
    want = moments.moment_sums_bwd_plain(*ins, ct)
    torch.cuda.synchronize()
    for name, o, a, w in zip(("dqkv", "dr_q", "de_q", "dr_k", "de_k"),
                             got, again, want):
        _close(o, w, name)
        assert torch.equal(o, a), f"{name} differs between two runs"


# (span, gp, stripes, has_pos): spans 1, 3 and 256 at ragged stripe counts
# (no multiple of any stripe tile, nor of 4), both variants, every gp at the
# short spans; at span 256 the path's gp 2 and 4 and gp 16 (the smallest
# stripe tile, whose slab is largest)
MOMENTS_BWD_CARD_GEOMETRIES = [
    (1, 2, 301, True), (1, 16, 77, False), (3, 4, 301, False),
    (3, 8, 130, True), (256, 2, 301, True), (256, 4, 301, False),
    (256, 4, 1030, True), (256, 16, 77, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("L,gp,S,has_pos", MOMENTS_BWD_CARD_GEOMETRIES)
def test_moments_backward_matches_plain_on_card(cuda_device, L, gp, S,
                                                has_pos):
    """The one-launch moments backward: dqkv (v rows zero) and the table
    gradients per tensor at 1e-4 + 1e-4 * max|plain|; the same bits on a
    second run; one launch counted per call."""
    ins = moment_inputs(30, 8, gp, L, S, has_pos, device=cuda_device)
    ct = torch.from_numpy(np.random.default_rng(31).normal(size=(8, 8))
                          .astype(np.float32)).to(cuda_device)
    fn = moments.moment_sums_bwd
    before = fn.launches
    got = fn(*ins, ct)
    again = fn(*ins, ct)
    want = moments.moment_sums_bwd_plain(*ins, ct)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert not got[0][:, gp:].any(), "v rows of dqkv must be zero"
    for name, o, a, w in zip(("dqkv", "dr_q", "de_q", "dr_k", "de_k"),
                             got, again, want):
        _close(o, w, name)
        assert torch.equal(o, a), f"{name} differs between two runs"


def test_moments_backward_buffers_follow_the_kernel_tile():
    """The moments backward's table partials have one slot per block, and
    the wrapper sizes them from the kernel's own tile rule, read here from
    csrc/moments.cu (kSlabFloats, kMinTile, kMaxTile, kMinBlocks,
    kMaxBwdSpan): the largest stripe tile of 32, 16, 8 whose q/k slab fits
    and whose grid has at least kMinBlocks blocks. Every moments site of
    the MedT-128 batch-16 and medt_512 batch-4 paths gets at least 132
    blocks; at (256, 4, 1024) the partials take 6 MB."""
    src = (REPO / "medt_tpu_torch" / "csrc" / "moments.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    assert (const("kSlabFloats"), const("kMinTile"), const("kMaxTile"),
            const("kMinBlocks"), const("kMaxBwdSpan")) == (
        moments.BWD_SLAB_FLOATS, moments.BWD_MIN_TILE, moments.BWD_MAX_TILE,
        moments.BWD_MIN_BLOCKS, moments.BWD_MAX_SPAN)
    assert "while (ts > kMinTile &&" in src and "ts /= 2;" in src

    def tile(c, L, S, g):
        ts = const("kMaxTile")
        while ts > const("kMinTile") and (
                2 * c * L * ts > const("kSlabFloats")
                or g * -(-S // ts) < const("kMinBlocks")):
            ts //= 2
        return ts

    path = [(64, 2, 1024), (64, 4, 1024), (32, 4, 512), (16, 2, 4096),
            (16, 4, 4096), (8, 4, 2048), (8, 8, 2048), (4, 8, 1024),
            (4, 16, 1024), (256, 2, 1024), (256, 4, 1024), (128, 4, 512),
            (64, 2, 4096), (64, 4, 4096), (32, 4, 2048), (32, 8, 2048),
            (16, 8, 1024), (16, 16, 1024)]
    for L, gp, S in path + [(1, 2, 301), (3, 8, 130), (256, 16, 77)]:
        c = gp // 2
        ts = tile(c, L, S, 8)
        assert moments.bwd_tile(c, L, S, 8) == ts
        if (L, gp, S) in path:
            assert 8 * -(-S // ts) >= 132, (L, gp, S, ts)
        for pos in (True, False):
            qkv = torch.empty((8, 2 * gp, L, S), device="meta")
            dqkv, dtables, part, n_part = moments.bwd_buffers(
                qkv, 8, gp, L, S, pos)
            rows = 2 * c + 2 * c * c if pos else 0
            assert n_part == (8 * -(-S // ts) if pos else 0)
            assert dqkv.shape == (8, 2 * gp, L, S)
            assert dtables.shape == (rows, L)
            assert part.shape == (n_part, rows, L)
    _, _, part, _ = moments.bwd_buffers(
        torch.empty((8, 8, 256, 1024), device="meta"), 8, 4, 256, 1024, True)
    assert part.numel() * 4 == 6_291_456


# (span, gp, stripes, has_pos): the moments forward at the edges of its
# 32-stripe tile (csrc/moments.cu: kFwdStripes): stripe counts that are no
# multiple of 4 (the slab staged without 16-byte copies) or of the tile,
# fewer stripes than one tile, more than 32 groups of 4 tiles (the
# finalize in two rounds), tables staged (c <= 4, spans up to 256) or read
# from L2 (gp 16, and span 300), and slabs too large to stage (gp * L over
# 1024: the sums read device memory)
MOMENTS_FWD_CARD_GEOMETRIES = [
    (1, 2, 301, True), (3, 16, 77, False), (64, 4, 1030, True),
    (16, 8, 6, True), (256, 4, 301, True), (256, 16, 77, True),
    (300, 4, 33, True), (64, 2, 4099, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("L,gp,S,has_pos", MOMENTS_FWD_CARD_GEOMETRIES)
def test_moments_forward_matches_plain_on_card(cuda_device, L, gp, S,
                                               has_pos):
    """The moments forward (one tile launch and its finalize): the (g, 8)
    sums at 1e-4 + 1e-4 * max|plain|, the same bits on a second run, one
    launch counted per call."""
    ins = moment_inputs(33, 8, gp, L, S, has_pos, device=cuda_device)
    fn = moments.moment_sums_fwd
    before = fn.launches
    got, again = fn(*ins), fn(*ins)
    want = moments.moment_sums_plain(*ins)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    _close(got, want, "sums")
    assert torch.equal(got, again), "sums differ between two runs"


def test_moments_forward_buffers_follow_the_kernel_tile():
    """The moments forward has one (g, tile) partial of six per block of
    kFwdStripes stripes (csrc/moments.cu), which the wrapper mirrors; every
    moments site of the MedT-128 batch-16 and medt_512 batch-4 paths gets
    at least 128 blocks (the first design: 16 to 256 blocks of 128 stripes),
    and the sums and partials share one allocation."""
    src = (REPO / "medt_tpu_torch" / "csrc" / "moments.cu").read_text()
    stripes = int(re.search(r"constexpr int kFwdStripes = (\d+);", src)
                  .group(1))
    assert stripes == moments.FWD_STRIPES
    fwd = src[src.index("int moments_fwd("):]  # both entry points' body
    assert "n_part != g * tiles" in fwd
    sys.path.insert(0, str(REPO))
    import chip_smoke

    sites = [(L, gp, S) for L, gp, S, _, _ in
             chip_smoke.SITES + chip_smoke.SITES_512]
    for L, gp, S in sites + [(1, 2, 301), (3, 16, 77), (300, 4, 33)]:
        qkv = torch.empty((8, 2 * gp, L, S), device="meta")
        out, part, n_part = moments.fwd_buffers(qkv, 8, gp, L, S)
        assert n_part == 8 * -(-S // stripes)
        if (L, gp, S) in sites:
            assert n_part >= 128, (L, gp, S)
        assert out.shape == (8, 8) and part.shape == (n_part, 6)
        assert part.storage_offset() == out.numel()


def test_stripe_backward_buffers_follow_the_kernel_chunks():
    """The stripe backward's partials have one slot per block, and the
    wrapper sizes them from the kernel's own chunk rule, read here from
    csrc/axial_stripe_bwd.cu (kWideGp, span_bucket, chunk_stripes): 4
    stripes a block with positions at span bucket 64 (spans 33..64) below
    kWideGp group planes, else 2. At every site of the smoke's STRIPE_SITES and at ragged
    stripe counts; at the batch-1 path sites the table partials take 8 MB
    (64, 2, 64), 16 MB (64, 4, 64) and 4 MB (32, 4, 32)."""
    src = (REPO / "medt_tpu_torch" / "csrc" /
           "axial_stripe_bwd.cu").read_text()
    wide = int(re.search(r"constexpr int kWideGp = (\d+);", src).group(1))
    assert wide == axial_train.BWD_WIDE_GP
    assert "return L <= 16 ? 16 : L <= 32 ? 32 : 64;" in src
    assert "return pos && lp == 64 && gp < kWideGp ? 4 : 2;" in src

    def chunk(gp, L, pos):
        lp = 16 if L <= 16 else 32 if L <= 32 else 64
        return 4 if pos and lp == 64 and gp < wide else 2

    sys.path.insert(0, str(REPO))
    import chip_smoke

    sites = [(L, gp, S) for L, gp, S, _ in chip_smoke.STRIPE_SITES]
    ragged = [(64, 4, 3), (64, 2, 70), (32, 8, 37), (48, 8, 21), (40, 4, 30),
              (37, 2, 11), (64, 16, 9), (12, 4, 19), (1, 2, 1)]
    for L, gp, S in sites + ragged:
        for pos in (True, False):
            ns = chunk(gp, L, pos)
            assert axial_train.bwd_chunk_stripes(gp, L, pos) == ns
            b = axial_train.bwd_buffers("meta", S, 8, gp, L, pos)
            blocks = -(-S // ns)
            rows = 2 * gp if pos else 0
            assert b["aff_part"].shape == (blocks, 8, 4)
            assert b["tab_part"].shape == (8 * blocks if pos else 0, rows,
                                           L, L)
            assert b["dtables"].shape == (rows, L, L)
            assert b["dq"].shape == b["dk"].shape == (S, 8, gp // 2, L)
            assert b["dv"].shape == (S, 8, gp, L)
            assert b["daff"].shape == (8, 8)

    def tab_bytes(L, gp, S):
        return axial_train.bwd_buffers("meta", S, 8, gp, L,
                                       True)["tab_part"].numel() * 4

    assert tab_bytes(64, 2, 64) == 8_388_608
    assert tab_bytes(64, 4, 64) == 16_777_216
    assert tab_bytes(32, 4, 32) == 4_194_304


@pytest.mark.cuda
def test_moments_backward_refuses_spans_above_256(cuda_device):
    ins = moment_inputs(32, 2, 2, 272, 64, False, device=cuda_device)
    with pytest.raises(ValueError, match="span"):
        moments.moment_sums_bwd(*ins, torch.zeros((2, 8), device=cuda_device))


@pytest.mark.cuda
def test_attention_train_step_on_kernels_matches_plain_cores(cuda_device):
    """One AxialAttention train-mode forward and backward through the
    kernels vs the same module on plain cores (gated, span 32: flash;
    random cotangent). Per tensor: 1e-5 + 1e-4 * max|plain| plus four times
    the spread of the plain step when its input is perturbed by 1e-6
    (relative; two runs), as chip_smoke.py's train phase holds the whole
    step. The similarity BN's bias gradient is 0 in exact arithmetic
    (softmax is shift-invariant): it is held at the scale of its weight
    gradient."""
    from medt_tpu_torch.ops.axial_attention import AxialAttention

    rng = np.random.default_rng(18)
    x = rng.normal(size=(4, 16, 32, 32)).astype(np.float32)
    ct = torch.from_numpy(rng.normal(size=(4, 16, 32, 32))
                          .astype(np.float32)).to(cuda_device)

    def grads(plain, noise=0.0):
        op = AxialAttention(16, 16, 32, groups=8, mode="gated",
                            use_fused=True, plain_cores=plain,
                            generator=torch.Generator().manual_seed(0),
                            device=cuda_device).train()
        xi = x * (1.0 + noise * rng.standard_normal(x.shape))
        xt = torch.from_numpy(xi.astype(np.float32)).to(cuda_device)
        xt.requires_grad_()
        (op(xt) * ct).sum().backward()
        return dict([("input", xt.grad)] + [
            (name, p.grad) for name, p in op.named_parameters()
            if p.requires_grad])

    got, want = grads(False), grads(True)
    spread = [want] + [grads(True, 1e-6) for _ in range(2)]
    bad = []
    for name, g in got.items():
        runs = [r[name] for r in spread]
        noise = max(float((a - b).abs().max()) for i, a in enumerate(runs)
                    for b in runs[i + 1:])
        scale = want["bn_similarity.weight" if name == "bn_similarity.bias"
                     else name].abs().max()
        err = float((g - want[name]).abs().max())
        if not err <= 1e-5 + 1e-4 * float(scale) + 4.0 * noise:
            bad.append((name, err, float(scale), noise))
    assert not bad, bad


# the smoke's eval geometries: MedT-128 batch 1, then gatedaxialunet-128's;
# and odd shapes (spans that are not a power of two, a ragged last block)
EVAL_GEOMETRIES = [
    (4, 8, 64, False), (4, 16, 64, False), (32, 4, 32, True),
    (64, 2, 64, True), (64, 4, 64, True), (16, 8, 16, True),
    (16, 16, 16, True), (32, 8, 32, True),
    (6, 4, 37, True), (20, 16, 9, False), (64, 16, 5, True), (1, 2, 3, True),
] + [
    # spans over 16, where a query row's keys are spread over lanes: spans
    # that fill no bucket (17, 33, 48, 63; the odd ones take 4-byte
    # copies), both variants, ragged stripe counts; S = 1; gp 16 at span 64
    (L, gp, S, pos) for L, gp, S in ((17, 4, 37), (33, 8, 21), (48, 2, 64),
                                     (63, 16, 5))
    for pos in (True, False)
] + [(40, 4, 1, True), (64, 2, 1, False), (64, 16, 64, True),
     (64, 16, 33, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("L,gp,S,has_pos", EVAL_GEOMETRIES)
def test_eval_kernel_matches_plain_on_card(cuda_device, L, gp, S, has_pos):
    """Output within 1e-4 of the plain version, the same bits on a second
    run, one launch counted per call."""
    args = eval_inputs(20, g=8, gp=gp, L=L, S=S, has_pos=has_pos,
                       device=cuda_device)
    fn = axial_eval.axial_eval_fwd
    before = fn.launches
    got, again = fn(*args), fn(*args)
    want = axial_eval.axial_attention_fused_plain(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_eval_kernel_takes_zero_tables_and_dense_operands(cuda_device):
    """The Pallas contract's position-free call (zero tables, dense q, k,
    v) gives what the zero-size tables give."""
    q, k, v, _, _, _, aff, oa = eval_inputs(21, g=8, gp=8, L=4, S=64,
                                            has_pos=False,
                                            device=cuda_device)
    zc = torch.zeros((4, 4, 4), device=cuda_device)
    zv = torch.zeros((8, 4, 4), device=cuda_device)
    empty = torch.zeros((0, 4, 4), device=cuda_device)
    dense = [t.contiguous() for t in (q, k, v)]
    got = axial_eval.axial_eval_fwd(*dense, zc, zc, zv, aff, oa)
    want = axial_eval.axial_eval_fwd(q, k, v, empty, empty, empty, aff, oa)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="rows"):
        axial_eval.axial_eval_fwd(q.transpose(0, 1).contiguous()
                                  .transpose(0, 1).transpose(2, 3)
                                  .contiguous().transpose(2, 3), k, v,
                                  empty, empty, empty, aff, oa)


# ---- flash2: spans 65..256 ---------------------------------------------------

# (span, gp, stripes, has_pos): the medt_512 global sites at a cut stripe
# count, both variants, every gp, spans that are not a multiple of the key
# block, a ragged last stripe block; the (256, 4) site at its full batch-4
# width; at the path's gp, a span that is no multiple of any query or key
# tile (100) and one that is no multiple of 4 (99: 4-byte table copies),
# and fewer stripes than one tile, no multiple of 4 (33)
FLASH2_CARD_GEOMETRIES = [
    (256, 2, 300, True), (256, 4, 130, True), (128, 4, 300, True),
    (96, 2, 300, False), (200, 8, 130, True), (72, 16, 130, False),
    (256, 16, 130, True), (256, 4, 1024, True), (100, 4, 33, True),
    (99, 2, 64, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("L,gp,S,has_pos", FLASH2_CARD_GEOMETRIES)
def test_flash2_kernels_match_plain_on_card(cuda_device, L, gp, S, has_pos):
    """Forward (sv, sve at 1e-4; m, l also at rtol 1e-5) and backward (per
    tensor 1e-4 + 1e-4 * max|plain|) against the plain versions, the same
    bits on a second run, one launch counted per call."""
    args = core_inputs(24, g=8, gp=gp, L=L, S=S, has_pos=has_pos,
                       device=cuda_device)
    fwd, bwd = axial_lanes.flash2_lanes_fwd, axial_lanes.flash2_lanes_bwd
    before = (fwd.launches, bwd.launches)
    got, again = fwd(*args), fwd(*args)
    want = axial_lanes.flash2_lanes_plain(*args)
    torch.cuda.synchronize()
    for name, o, a, w in zip(("sv", "sve", "m", "l"), got, again, want):
        rtol = 1e-5 if name in ("m", "l") else 0.0
        torch.testing.assert_close(o, w, atol=1e-4, rtol=rtol, msg=name)
        assert torch.equal(o, a), f"{name} differs between two runs"
    sv, sve, m, l = want
    dsv, dsve = _grads_in(25, 8, gp, L, S, cuda_device)
    saved = (m, l, sv, sve.contiguous())
    got = bwd(*args, *saved, dsv, dsve)
    again = bwd(*args, *saved, dsv, dsve)
    want = axial_lanes.flash2_lanes_bwd_plain(*args, *saved, dsv, dsve)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 2, before[1] + 2)
    for name, o, a, w in zip(("dqkv", "dqemb", "dkemb_t", "dvemb", "daff"),
                             got, again, want):
        _close(o, w, name)
        assert torch.equal(o, a), f"{name} differs between two runs"


# (span, gp, stripes, has_pos) of the long-span wide kernels (the flash2
# wrappers at a wide gp, csrc/wide_long.cuh): every register bucket of c
# (gp 12, 24, 48, 128), spans 65, 96, 128 and 256 and 1, 45, 96 and 768
# stripes, each stripe count once with each bucket and each span (a Latin
# square), with and without positions
LONG_WIDE_CARD_GEOMETRIES = [
    (L, gp, (1, 45, 96, 768)[(b + k) % 4], pos)
    for b, gp in enumerate((12, 24, 48, 128))
    for k, L in enumerate((65, 96, 128, 256)) for pos in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("L,gp,S,has_pos", LONG_WIDE_CARD_GEOMETRIES)
def test_long_wide_kernels_match_plain_on_card(cuda_device, L, gp, S,
                                               has_pos):
    """The long-span wide forward and backward against the plain versions
    (forward: sv, sve at 1e-4, m and l also at rtol 1e-5; backward 1e-4 +
    1e-4 * max|plain| per tensor), the same bits on a second run, one
    launch counted per call, and the bf16 entry points equal to the
    float32 kernels on the upcast qkv, bit for bit (dqkv: the float32 dqkv
    rounded once)."""
    args = core_inputs(26, g=8, gp=gp, L=L, S=S, has_pos=has_pos,
                       device=cuda_device)
    fwd, bwd = axial_lanes.flash2_lanes_fwd, axial_lanes.flash2_lanes_bwd
    before = (fwd.launches, bwd.launches)
    got, again = fwd(*args), fwd(*args)
    want = axial_lanes.flash2_lanes_plain(*args)
    torch.cuda.synchronize()
    for name, o, a, w in zip(("sv", "sve", "m", "l"), got, again, want):
        rtol = 1e-5 if name in ("m", "l") else 0.0
        torch.testing.assert_close(o, w, atol=1e-4, rtol=rtol, msg=name)
        assert torch.equal(o, a), f"{name} differs between two runs"
    sv, sve, m, l = want
    dsv, dsve = _grads_in(27, 8, gp, L, S, cuda_device)
    saved = (m, l, sv, sve.contiguous())
    grads = bwd(*args, *saved, dsv, dsve)
    again = bwd(*args, *saved, dsv, dsve)
    want = axial_lanes.flash2_lanes_bwd_plain(*args, *saved, dsv, dsve)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 2, before[1] + 2)
    names = ("dqkv", "dqemb", "dkemb_t", "dvemb", "daff")
    for name, o, a, w in zip(names, grads, again, want):
        _close(o, w, name)
        assert torch.equal(o, a), f"{name} differs between two runs"
    half = (args[0].bfloat16(), *args[1:])
    twin = (half[0].float(), *args[1:])
    before = (fwd.launches_bf16, bwd.launches_bf16)
    for name, o, w in zip(("sv", "sve", "m", "l"), fwd(*half), fwd(*twin)):
        assert torch.equal(o, w), f"bf16 {name}"
    got_b = bwd(*half, *saved, dsv, dsve)
    got_t = bwd(*twin, *saved, dsv, dsve)
    torch.cuda.synchronize()
    assert (fwd.launches_bf16, bwd.launches_bf16) == (before[0] + 1,
                                                      before[1] + 1)
    assert got_b[0].dtype == torch.bfloat16
    assert torch.equal(got_b[0], got_t[0].to(torch.bfloat16)), "bf16 dqkv"
    for name, o, w in zip(names[1:], got_b[1:], got_t[1:]):
        assert torch.equal(o, w), f"bf16 {name}"


def test_flash2_backward_buffers_follow_the_kernel_tiles():
    """The lanes, flash and flash2 backwards' partials are sized from their
    kernels' own tiles, read here from the sources: the tiled flash and
    flash2 row pass (csrc/tiled_bwd.cuh: kRowStripes stripes; kRowQueries of
    Flash2Tiles, which FlashTiles shares, query rows per block by gp), whose
    scratch holds delta and the row normaliser; the lanes kernel (csrc/axial_lanes_bwd.cu: kThreads
    threads, one per (row, stripe) of a chunk of kThreads / LP stripes, LP
    the span's bucket; with positions at most ceil(kGridBlocks / g) blocks
    per group), which needs no scratch. At the largest path sites the
    partials are: lanes (16, 2, 4096) 32 KB of daff partials (with
    positions, off the path, 4.3 MB of table partials); flash (64, 4, 1024)
    with positions 8 MB of table partials and 4 MB of scratch, (64, 4,
    4096) without 16 MB of scratch; flash2 (256, 4, 1024) 134 MB of table
    partials."""
    csrc = REPO / "medt_tpu_torch" / "csrc"

    def const(name, text):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    tiled_src = (csrc / "tiled_bwd.cuh").read_text()
    stripes = const("kRowStripes", tiled_src)
    vals = re.search(r"kRowQueries\[5\] = \{([^}]*)\}", tiled_src).group(1)
    rows = [int(x) for x in vals.split(",")]
    lanes_src = (csrc / "axial_lanes_bwd.cu").read_text()
    assert stripes == axial_lanes.ROW_STRIPES
    assert axial_lanes.ROW_QUERIES == {
        gp: rows[gp.bit_length() - 1] for gp in (2, 4, 8, 16)}
    assert "struct FlashTiles : Flash2Tiles {" in tiled_src
    assert const("kThreads", lanes_src) == axial_lanes.LANES_THREADS
    assert const("kGridBlocks", lanes_src) == axial_lanes.LANES_GRID_BLOCKS
    assert "return L <= 4 ? 4 : L <= 8 ? 8 : 16;" in lanes_src
    for g, gp, L, S, pos in [(8, 4, 256, 1024, True), (8, 2, 256, 1024, True),
                             (8, 4, 128, 512, True), (2, 2, 99, 33, True),
                             (3, 8, 200, 300, True), (8, 16, 72, 130, False),
                             (8, 4, 64, 1024, True), (8, 8, 32, 2048, False),
                             (8, 2, 16, 4096, False), (8, 2, 16, 4096, True),
                             (8, 16, 4, 1024, False), (3, 8, 12, 300, True),
                             (8, 4, 3, 9, True), (8, 8, 20, 300, True)]:
        qkv = torch.empty((g, 2 * gp, L, S), device="meta")
        kinds = ["tiled"] + (["lanes"] if L <= 16 else [])
        for kind in kinds:
            b, n_tab, n_aff = axial_lanes._bwd_buffers(qkv, kind, g, gp, L, S,
                                                       pos)
            if kind == "lanes":
                ns = const("kThreads", lanes_src) // (
                    4 if L <= 4 else 8 if L <= 8 else 16)
                blocks = -(-S // ns)
                if pos:
                    blocks = min(blocks, -(-const("kGridBlocks", lanes_src)
                                           // g))
                want = (g * blocks if pos else 0, blocks, 0)
            else:
                q_rows = rows[gp.bit_length() - 1]
                chunks = -(-S // stripes)
                want = (g * chunks if pos else 0, -(-L // q_rows) * chunks, 2)
            assert (n_tab, n_aff, b["scratch"].shape[0]) == want, (kind, L)
            assert b["tab_part"].shape == (n_tab, 2 * gp if pos else 0, L, L)
            assert b["aff_part"].shape == (n_aff, g, 4)
            assert b["scratch"].shape == (want[2], g, L, S)
            assert b["dqkv"].shape == (g, 2 * gp, L, S)
            assert b["dtables"].shape == (2 * gp if pos else 0, L, L)
            assert b["daff"].shape == (g, 8)

    def nbytes(kind, g, gp, L, S, pos):
        qkv = torch.empty((g, 2 * gp, L, S), device="meta")
        b, _, _ = axial_lanes._bwd_buffers(qkv, kind, g, gp, L, S, pos)
        return (b["tab_part"].numel() * 4, b["aff_part"].numel() * 4,
                b["scratch"].numel() * 4)

    assert nbytes("lanes", 8, 2, 16, 4096, False) == (0, 32_768, 0)
    assert nbytes("lanes", 8, 2, 16, 4096, True) == (4_325_376, 16_896, 0)
    assert nbytes("tiled", 8, 4, 64, 1024, True) == (8_388_608, 8_192,
                                                      4_194_304)
    assert nbytes("tiled", 8, 4, 64, 4096, False) == (0, 32_768, 16_777_216)
    assert nbytes("tiled", 8, 4, 256, 1024, True)[0] == 134_217_728


def test_smoke_labels_kernels_by_their_mangled_names():
    """chip_smoke.py's ptxas summary names each kernel by the length-prefixed
    identifier ending in ``_kernel`` (flash2's names hold a digit; nvcc's
    anonymous-namespace prefixes hold hashes), with its template args."""
    sys.path.insert(0, str(REPO))
    try:
        from chip_smoke import kernel_label
    finally:
        sys.path.remove(str(REPO))
    prefix = "_ZN36_INTERNAL_5dc0_19_axial_flash2_bwd_cu_463bf0b1"
    assert kernel_label(prefix + "27flash2_tiled_bwd_col_kernelILi16ELb0EEEvNS_"
                        "7BwdArgsE") == "flash2_tiled_bwd_col_kernelILi16ELb0EE"
    assert kernel_label("_ZN4medt36_INTERNAL_8a1c2d3e_18_axial_lanes_bwd_cu_"
                        "5d7a2c1e19sum_partials_kernelEPKfPfim") \
        == "sum_partials_kernel"
    assert kernel_label("_ZN12_GLOBAL__N_120lanes_bwd_row_kernelILi2ELb0EEEv"
                        "NS_13LanesBwdArgsE") == "lanes_bwd_row_kernelILi2ELb0EE"
    assert kernel_label("_ZN6flash212_GLOBAL__N_120tiled_bwd_row_kernelIN12_"
                        "GLOBAL__N_110FlashTilesELi4ELb1EEEvNS0_7BwdArgsE") \
        == "tiled_bwd_row_kernelIN12_GLOBAL__N_110FlashTilesELi4ELb1EE"
    assert kernel_label("_ZN6flash212_GLOBAL__N_116tiled_fwd_kernelINS0_13"
                        "FlashFwdTilesELi4ELb0EEEvNS0_7FwdArgsE") \
        == "tiled_fwd_kernelINS0_13FlashFwdTilesELi4ELb0EE"
    assert kernel_label("_Z3foov") == "_Z3foov"


@pytest.mark.cuda
def test_flash2_wrappers_refuse_spans_above_256(cuda_device):
    args = core_inputs(26, g=2, gp=2, L=272, S=128, has_pos=False,
                       device=cuda_device)
    with pytest.raises(ValueError, match="span"):
        axial_lanes.flash2_lanes_fwd(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("gp,L,S", [(2, 256, 300), (4, 256, 130),
                                    (4, 128, 300)])
def test_moment_kernels_match_plain_at_long_spans_on_card(cuda_device, gp, L,
                                                          S):
    """The moments at the 512 px models' global sites (positions, spans
    128 and 256: sums of up to S * L * L terms), per tensor at 1e-4 +
    1e-4 * max|plain|, the same bits on a second run."""
    ins = moment_inputs(27, 8, gp, L, S, True, device=cuda_device)
    ct = torch.from_numpy(np.random.default_rng(28).normal(size=(8, 8))
                          .astype(np.float32)).to(cuda_device)
    got, again = moments.moment_sums_fwd(*ins), moments.moment_sums_fwd(*ins)
    _close(got, moments.moment_sums_plain(*ins), "sums")
    assert torch.equal(got, again)
    got = moments.moment_sums_bwd(*ins, ct)
    again = moments.moment_sums_bwd(*ins, ct)
    want = moments.moment_sums_bwd_plain(*ins, ct)
    torch.cuda.synchronize()
    for name, o, a, w in zip(("dqkv", "dr_q", "de_q", "dr_k", "de_k"),
                             got, again, want):
        _close(o, w, name)
        assert torch.equal(o, a), f"{name} differs between two runs"


# ---- the stripe train core: spans 32..64, few stripes --------------------------

# (span, gp, stripes, has_pos): the batch-1 and batch-2 train sites of MedT
# and gatedaxialunet at 128 and 64 px, both variants; span 64 at gp 8 and
# 16 off the path; a span that is not a power of two and ragged stripe
# blocks. Then the edges of the backward's chunks (csrc/axial_stripe_bwd.cu:
# 4 stripes a block with positions at spans 33..64 below gp 8, else 2):
# fewer stripes than one chunk, stripe counts that are no multiple of it,
# spans 40 and 48 (keys past the span bucket), a span that is no multiple
# of 4 (the tile staged without 16-byte copies), gp 16 with positions at
# span buckets 32 (kemb staged) and 64 (kemb from L2), and a short span
STRIPE_CARD_GEOMETRIES = [
    (64, 2, 64, True), (64, 4, 64, True), (32, 4, 32, True),
    (32, 8, 32, True), (32, 4, 64, False), (32, 2, 32, False),
    (64, 8, 64, True), (64, 16, 37, True), (48, 4, 70, False),
    (40, 2, 5, True),
    (64, 4, 3, True), (32, 4, 1, True), (64, 2, 1, False),
    (32, 4, 5, True), (64, 2, 70, True), (32, 8, 37, False),
    (40, 4, 30, True), (48, 8, 21, True), (37, 2, 11, True),
    (32, 16, 12, True), (64, 16, 9, True), (12, 4, 19, True),
] + [
    # the edges of the forward's warp-over-keys body (csrc/stripe_attn_fwd
    # .cuh): spans that fill no bucket (17, 33, 48, 63; the odd ones take
    # 4-byte copies), both variants, at ragged stripe counts
    (L, gp, S, pos) for L, gp, S in ((17, 4, 37), (33, 8, 21), (48, 2, 19),
                                     (63, 16, 5))
    for pos in (True, False)
] + [
    # S = 1 at spans 40 and 64; gp 16 at span 64 in both variants
    (40, 4, 1, True), (64, 8, 1, True), (64, 16, 64, True),
    (64, 16, 33, False),
    # a last block of pairs that is ragged at each span bucket: g = 8 and a
    # block takes PB = 16 pairs at these stripe counts (PB doubles from 2-8
    # while the grid keeps 264 blocks; 16 from the start at span 64 with
    # positions), so an odd S leaves it half full; (64, 8, 17) in blocks of
    # 8 warps, which a grid under 66 blocks takes
    (4, 4, 527, True), (8, 4, 527, False), (16, 4, 527, True),
    (32, 4, 263, True), (32, 8, 263, False), (64, 2, 131, False),
    (64, 4, 33, True), (64, 8, 17, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("L,gp,S,has_pos", STRIPE_CARD_GEOMETRIES)
def test_stripe_kernels_match_plain_on_card(cuda_device, L, gp, S, has_pos):
    """Forward (sv, sve at 1e-4) and backward (per tensor 1e-4 + 1e-4 *
    max|plain|) against the plain versions, the same bits on a second run,
    one launch counted per call."""
    args = stripe_inputs(26, g=8, gp=gp, L=L, S=S, has_pos=has_pos,
                         device=cuda_device)
    fwd, bwd = axial_train.stripe_attn_fwd, axial_train.stripe_attn_bwd
    before = (fwd.launches, bwd.launches)
    got, again = fwd(*args), fwd(*args)
    want = axial_train.attn_core_plain(*args, has_pos=has_pos)
    torch.cuda.synchronize()
    for name, o, a, w in zip(("sv", "sve"), got, again, want):
        torch.testing.assert_close(o, w, atol=1e-4, rtol=0, msg=name)
        assert torch.equal(o, a), f"{name} differs between two runs"
    rng = np.random.default_rng(27)
    dsv, dsve = (torch.from_numpy(rng.normal(size=(S, 8, gp, L))
                                  .astype(np.float32)).to(cuda_device)
                 for _ in range(2))
    got = bwd(*args, dsv, dsve)
    again = bwd(*args, dsv, dsve)
    want = axial_train.fused_attn_bwd_plain(*args, dsv, dsve)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 2, before[1] + 2)
    names = ("dq", "dk", "dv", "dqemb", "dkemb", "dvemb", "daff")
    for name, o, a, w in zip(names, got, again, want):
        if not w.numel():
            assert not o.numel(), name
            continue
        _close(o, w, name)
        assert torch.equal(o, a), f"{name} differs between two runs"


@pytest.mark.cuda
@pytest.mark.parametrize("L,gp,S,has_pos", [
    (64, 2, 64, True), (64, 4, 64, True), (32, 4, 32, True),
    (32, 8, 32, True), (32, 4, 64, False), (63, 16, 5, True),
    (17, 4, 37, False), (8, 8, 19, True),
])
def test_stripe_forward_shares_the_eval_body_on_card(cuda_device, L, gp, S,
                                                     has_pos):
    """The stripe forward and the eval kernel run one body
    (csrc/stripe_attn_fwd.cuh) with one arithmetic: on the same operands
    the eval kernel's output under an identity output affine (oa0 = 1, oa1
    = oa2 = oa3 = 0) is the stripe forward's sv, bit for bit, and under
    (0, 0, 1, 0) its sve."""
    args = stripe_inputs(31, g=8, gp=gp, L=L, S=S, has_pos=has_pos,
                         device=cuda_device)
    sv, sve = axial_train.stripe_attn_fwd(*args)
    for plane, want in ((0, sv), (2, sve)):
        if plane and not has_pos:
            continue
        oa = torch.zeros((8, 4, gp), device=cuda_device)
        oa[:, plane] = 1.0
        out = axial_eval.axial_eval_fwd(*args, oa)
        torch.cuda.synchronize()
        assert torch.equal(out, want), (plane, float((out - want).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("has_pos", [True, False])
def test_stripe_kernels_take_views_of_one_qkv(cuda_device, has_pos):
    """q, k, v as views of one stripe-major (S, g, 2gp, L) qkv, as the
    stripe route passes them, give the bits of their dense copies, forward
    and backward; rows that are not contiguous are refused."""
    dense = stripe_inputs(30, g=8, gp=4, L=64, S=64, has_pos=has_pos,
                          device=cuda_device)
    qkv = torch.cat(dense[:3], dim=2)
    views = (qkv[:, :, :2], qkv[:, :, 2:4], qkv[:, :, 4:]) + dense[3:]
    assert not views[0].is_contiguous()
    fwd, bwd = axial_train.stripe_attn_fwd, axial_train.stripe_attn_bwd
    dsv = torch.randn((64, 8, 4, 64), device=cuda_device)
    for got, want in ((fwd(*views), fwd(*dense)),
                      (bwd(*views, dsv, dsv), bwd(*dense, dsv, dsv))):
        torch.cuda.synchronize()
        for o, w in zip(got, want):
            assert torch.equal(o, w)
    q = dense[0].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="rows"):
        fwd(q, *dense[1:])


@pytest.mark.cuda
def test_stripe_kernels_take_zero_tables(cuda_device):
    """JAX's position-free call (zero tables) gives sv, dq, dk, dv of the
    zero-size call, a zero sve and, with its zero qr and kr affines, zero
    dqemb and dkemb."""
    q, k, v, _, _, _, aff = stripe_inputs(28, g=8, gp=4, L=32, S=32,
                                          has_pos=False, device=cuda_device)
    zc = torch.zeros((2, 32, 32), device=cuda_device)
    zv = torch.zeros((4, 32, 32), device=cuda_device)
    empty = torch.zeros((0, 32, 32), device=cuda_device)
    sv_z, sve_z = axial_train.stripe_attn_fwd(q, k, v, zc, zc, zv, aff)
    sv_e, sve_e = axial_train.stripe_attn_fwd(q, k, v, empty, empty, empty,
                                              aff)
    dsv = torch.ones_like(sv_e)
    gz = axial_train.stripe_attn_bwd(q, k, v, zc, zc, zv, aff, dsv, dsv)
    ge = axial_train.stripe_attn_bwd(q, k, v, empty, empty, empty, aff, dsv,
                                     dsv)
    torch.cuda.synchronize()
    torch.testing.assert_close(sv_z, sv_e, atol=1e-6, rtol=1e-6)
    assert not sve_z.any() and not sve_e.any()
    for a, b in zip(gz[:3], ge[:3]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert not any(t.any() for t in gz[3:5])
    with pytest.raises(ValueError, match="span"):
        axial_train.stripe_attn_fwd(
            *stripe_inputs(29, g=8, gp=4, L=72, S=8, has_pos=False,
                           device=cuda_device))


# ---- bf16 entry points (kernel rows 1-8) ---------------------------------------

BF16_WRAPPERS = (axial_lanes.lanes_attn_fwd, axial_lanes.flash_lanes_fwd,
                 axial_lanes.flash2_lanes_fwd, axial_lanes.lanes_attn_bwd,
                 axial_lanes.flash_lanes_bwd, axial_lanes.flash2_lanes_bwd,
                 moments.moment_sums_fwd, moments.moment_sums_bwd)


def test_bf16_entry_points_are_bound_and_counted():
    """Each of rows 1-8 has a bf16 C entry point beside its float32 one,
    defined in the sources, with the float32 one's arguments, and its
    wrapper counts bf16 launches under ``<name>_bf16``."""
    text = "".join(p.read_text() for p in sorted(
        (REPO / "medt_tpu_torch" / "csrc").glob("*.cu")))
    counts = {**axial_lanes.launch_counts(), **moments.launch_counts()}
    for fn in BF16_WRAPPERS:
        name = f"medt_{fn.__name__}"
        assert kbuild.SIGNATURES[f"{name}_bf16"] == kbuild.SIGNATURES[name]
        assert re.search(rf"\bint {name}_bf16\(const __nv_bfloat16\* qkv",
                         text), name
        assert f"{fn.__name__}_bf16" in counts and hasattr(fn,
                                                           "launches_bf16")


def _bf16_calls(fn, L, gp, S, has_pos, device):
    """(call on bf16 qkv, call on its float32 upcast) of a bf16 wrapper."""
    if fn.__name__.startswith("moment"):
        qkv, *rest = moment_inputs(24, 8, gp, L, S, has_pos, device)
        if fn is moments.moment_sums_bwd:
            rest.append(torch.randn((8, 8), device=device))
    else:
        qkv, *rest = core_inputs(24, g=8, gp=gp, L=L, S=S, has_pos=has_pos,
                                 device=device)
        if fn.__name__.endswith("_bwd"):
            saved = []
            if fn is not axial_lanes.lanes_attn_bwd:
                sv, sve, m, l = axial_lanes.flash_lanes_plain(
                    qkv.to(torch.bfloat16).float(), *rest)
                saved = [m, l, sv, sve.contiguous()]
            rest = rest + saved + _grads_in(25, 8, gp, L, S, device)
    q = qkv.to(torch.bfloat16)
    return (lambda: fn(q, *rest)), (lambda: fn(q.float(), *rest))


# (wrapper, span, gp, stripes, has_pos): a multiple of 8 stripes (16-byte
# copies) and ragged counts (S % 8 = 4, odd: element copies), both has_pos
# variants
BF16_CARD_GEOMETRIES = [
    (fn, L, gp, S, pos)
    for fn in BF16_WRAPPERS
    for L, gp in ((((16, 4) if "lanes_attn" in fn.__name__ else
                    (96, 2) if "flash2" in fn.__name__ else (32, 4)),))
    for S, pos in ((256, True), (100, False), (37, True))
]


@pytest.mark.cuda
@pytest.mark.parametrize("fn,L,gp,S,has_pos", BF16_CARD_GEOMETRIES,
                         ids=lambda v: getattr(v, "__name__", str(v)))
def test_bf16_kernel_equals_float32_kernel_on_upcast(cuda_device, fn, L, gp,
                                                     S, has_pos):
    """A bf16 entry point converts where it reads and keeps the float32
    kernel's arithmetic: its float32 outputs equal the float32 kernel's on
    the upcast qkv bit for bit, and its bf16 dqkv is that kernel's dqkv
    rounded once."""
    bf16, f32 = _bf16_calls(fn, L, gp, S, has_pos, cuda_device)
    before = (fn.launches, fn.launches_bf16)
    got, want = bf16(), f32()
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_bf16) == (before[0] + 1, before[1] + 1)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for i, (o, w) in enumerate(zip(got, want)):
        if fn.__name__.endswith("_bwd") and i == 0:
            assert o.dtype == torch.bfloat16
            assert torch.equal(o, w.to(torch.bfloat16)), "dqkv"
        else:
            assert o.dtype == torch.float32 and torch.equal(o, w), i


@pytest.mark.cuda
def test_bf16_wrappers_take_bf16_qkv_only(cuda_device):
    qkv, qemb, kemb_t, vemb, aff = core_inputs(26, g=2, gp=4, L=8, S=128,
                                               has_pos=True,
                                               device=cuda_device)
    fn = axial_lanes.lanes_attn_fwd
    with pytest.raises(TypeError, match="qemb"):
        fn(qkv.bfloat16(), qemb.bfloat16(), kemb_t, vemb, aff)
    with pytest.raises(TypeError, match="qkv"):
        fn(qkv.half(), qemb, kemb_t, vemb, aff)


# ---- gp 32 and 64 (the axial-attention classifiers' layers 3 and 4) ---------

# (kernel, span, gp, stripes, has_pos): each new variant at an axial26s site
# and at ragged stripe counts (S % 8 = 0, 4 and odd), spans that fill no
# block, both variants
WIDE_CARD_GEOMETRIES = [
    ("lanes", 14, 32, 112, True), ("lanes", 14, 64, 116, True),
    ("lanes", 16, 32, 37, False), ("lanes", 4, 64, 300, True),
    ("flash", 28, 32, 224, True), ("flash", 56, 32, 36, True),
    ("flash", 64, 64, 33, False), ("flash", 17, 64, 8, True),
    ("moments", 14, 32, 112, True), ("moments", 28, 32, 228, True),
    ("moments", 14, 64, 41, False), ("moments", 56, 64, 16, True),
    ("eval", 14, 32, 112, True), ("eval", 14, 64, 28, True),
    ("eval", 56, 32, 5, False), ("eval", 64, 64, 1, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,L,gp,S,has_pos", WIDE_CARD_GEOMETRIES)
def test_wide_gp_kernels_match_plain_on_card(cuda_device, kernel, L, gp, S,
                                             has_pos):
    """Forward and backward (the eval kernel: forward only) at gp 32 and
    64 against the plain versions at the file's tolerances; the same bits
    on a second run; one launch counted per call."""
    if kernel == "eval":
        args = eval_inputs(41, g=8, gp=gp, L=L, S=S, has_pos=has_pos,
                           device=cuda_device)
        calls = [(axial_eval.axial_eval_fwd, args,
                  lambda: (axial_eval.axial_attention_fused_plain(*args),))]
    elif kernel == "moments":
        ins = moment_inputs(42, 8, gp, L, S, has_pos, device=cuda_device)
        ct = torch.from_numpy(np.random.default_rng(43).normal(size=(8, 8))
                              .astype(np.float32)).to(cuda_device)
        calls = [(moments.moment_sums_fwd, ins,
                  lambda: (moments.moment_sums_plain(*ins),)),
                 (moments.moment_sums_bwd, (*ins, ct),
                  lambda: moments.moment_sums_bwd_plain(*ins, ct))]
    else:
        args = core_inputs(44, g=8, gp=gp, L=L, S=S, has_pos=has_pos,
                           device=cuda_device)
        dsv, dsve = _grads_in(45, 8, gp, L, S, cuda_device)
        if kernel == "lanes":
            calls = [(axial_lanes.lanes_attn_fwd, args,
                      lambda: axial_lanes.lanes_attn_plain(*args)),
                     (axial_lanes.lanes_attn_bwd, (*args, dsv, dsve),
                      lambda: axial_lanes.lanes_attn_bwd_plain(*args, dsv,
                                                               dsve))]
        else:
            sv, sve, m, l = axial_lanes.flash_lanes_plain(*args)
            saved = (m, l, sv, sve)
            calls = [(axial_lanes.flash_lanes_fwd, args,
                      lambda: axial_lanes.flash_lanes_plain(*args)),
                     (axial_lanes.flash_lanes_bwd, (*args, *saved, dsv, dsve),
                      lambda: axial_lanes.flash_lanes_bwd_plain(
                          *args, *saved, dsv, dsve))]
    for fn, fargs, plain in calls:
        before = fn.launches
        got, again = fn(*fargs), fn(*fargs)
        if isinstance(got, torch.Tensor):
            got, again = (got,), (again,)
        want = plain()
        torch.cuda.synchronize()
        assert fn.launches == before + 2, fn.__name__
        for i, (o, a, w) in enumerate(zip(got, again, want)):
            name = f"{fn.__name__}[{i}]"
            if fn.__name__.endswith("_fwd") and kernel != "moments":
                rtol = 1e-5 if i >= 2 else 0.0   # flash: m and l
                torch.testing.assert_close(o, w, atol=1e-4, rtol=rtol,
                                           msg=name)
            else:
                _close(o, w, name)
            assert torch.equal(o, a), f"{name} differs between two runs"


def test_gp_outside_the_kernels_raises_value_error():
    """An odd gp and a gp over 128 raise ValueError naming the roadmap
    entry, at the wrappers (before any device check); the stripe kernels
    stop at gp 16 and flash2 takes a wide gp (its wrapper refuses a CPU
    tensor at gp 32 only for its device); every even gp from 2 to 128
    passes. On
    the fused path of AxialAttention, on any device and plain cores
    included, a wide gp runs (gp 12 in eval and train mode, equal to the
    plain attention on the same weights) and a train site at the stripe
    route's span and stripe count at gp 32 takes the flash route; nothing
    turns to the plain attention."""
    from medt_tpu_torch.ops import AxialAttention

    for gp in (7, 130):
        args = core_inputs(46, g=2, gp=gp, L=8, S=16, has_pos=True)
        with pytest.raises(ValueError, match="ROADMAP"):
            axial_lanes.lanes_attn_fwd(*args)
        with pytest.raises(ValueError, match="ROADMAP"):
            moments.moment_sums_fwd(*moment_inputs(46, 2, gp, 8, 16, True))
    with pytest.raises(ValueError, match="CUDA"):
        axial_lanes.flash2_lanes_fwd(*core_inputs(46, g=2, gp=32, L=80,
                                                  S=16, has_pos=True))
    with pytest.raises(ValueError, match="ROADMAP"):
        axial_lanes.check_gp("stripe_attn_fwd", 24, narrow_only=True)
    for gp in range(2, 130, 2):
        axial_lanes.check_gp("lanes_attn_fwd", gp)
    x = torch.from_numpy(np.random.default_rng(47).normal(
        size=(1, 24, 8, 4)).astype(np.float32))
    for train in (False, True):
        ref = AxialAttention(24, 96, 8, groups=8, mode="full",
                             device="cpu").train(train)
        sd = {k: v.clone() for k, v in ref.state_dict().items()}
        want = ref(x)
        for plain in (False, True):
            op = AxialAttention(24, 96, 8, groups=8, mode="full",
                                use_fused=True, plain_cores=plain,
                                device="cpu").train(train)
            op.load_state_dict(sd)
            torch.testing.assert_close(op(x), want, atol=1e-4, rtol=0)
            assert op.last_route[0] == ("lanes" if train else "eval")
            assert op.gp == 12
    # the stripe route (train mode, span 32..64, under 128 stripes) takes
    # gp 2 to 16; gp 32 there runs on the flash route
    stripe = AxialAttention(8, 256, 32, groups=8, mode="full",
                            use_fused=True, plain_cores=True,
                            device="cpu").train()
    assert stripe(torch.zeros(1, 8, 32, 2)).shape == (1, 256, 32, 2)
    assert stripe.last_route[0] == "flash"
