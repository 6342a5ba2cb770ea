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
import subprocess
import sys

import numpy as np
import pytest
import torch

from medt_tpu_torch.kernels import build as kbuild
from medt_tpu_torch.ops import axial_eval, axial_lanes, moments
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
    for fn in (axial_lanes.lanes_attn_fwd, axial_lanes.flash_lanes_fwd):
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


def test_cores_on_cpu_run_the_plain_versions():
    args = core_inputs(11, g=2, gp=4, L=8, S=64, has_pos=True)
    counts = axial_lanes.launch_counts()
    for got, want in zip(axial_lanes.lanes_attn_core(*args),
                         axial_lanes.lanes_attn_plain(*args)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert axial_lanes.launch_counts() == counts


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


# ---- nothing of JAX in the port ---------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "PIL", "medt_tpu",
             "torch.utils.cpp_extension")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_nothing_of_jax_ast():
    files = sorted((REPO / "medt_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Attribute):  # torch.utils.cpp_extension
                names = [node.attr]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}: {n}" for n in names
                    if _forbidden(n) or n == "cpp_extension"]
    assert not bad, bad


def test_port_imports_nothing_of_jax_at_runtime():
    """What importing the port loads (beyond what the interpreter had
    loaded before it) holds none of them."""
    code = ("import sys; before = set(sys.modules); "
            "import medt_tpu_torch.serving.engine, medt_tpu_torch.models, "
            "medt_tpu_torch.utils.weights, medt_tpu_torch.cli.test, "
            "medt_tpu_torch.cli.predict, medt_tpu_torch.data, "
            "medt_tpu_torch.config, medt_tpu_torch.training; "
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


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,L,gp,has_pos", [
    ("lanes", 16, 2, False), ("lanes", 4, 16, False), ("lanes", 8, 4, True),
    ("lanes", 16, 16, True), ("flash", 64, 2, True), ("flash", 32, 4, True),
    ("flash", 64, 4, False), ("flash", 20, 8, True),
])
def test_backward_kernel_matches_plain_on_card(cuda_device, kernel, L, gp,
                                               has_pos):
    """The five gradients; an odd stripe count (a ragged last block); the
    same bits on a second run."""
    S = 300
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
]


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
