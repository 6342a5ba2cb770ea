"""Forward lanes-attention cores: CUDA kernels and their plain versions.

Port of the forward halves of ``medt_tpu/ops/pallas_axial_lanes.py``:
``lanes_attn_core`` (spans <= 16) and ``flash_lanes_core`` (spans 17..64).
Same contract as the JAX functions::

    qkv     (g, 2gp, L, S)  rows [0:c]=q, [c:gp]=k, [gp:2gp]=v, c = gp//2
    qemb    (c, L, L)       zero-size (0, L, L) tables without positions
    kemb_t  (c, L, L)       swapped: kemb_t[c, i, j] = kemb[c, j, i]
    vemb    (gp, L, L)
    sim_affine (g, 8)       attn_core.pack_sim_affine layout
    -> sv, sve (g, gp, L, S); sve is zero without positions

Each core dispatches on where its input lies: on a CPU tensor it runs the
plain PyTorch version beside it; on a CUDA tensor it launches the kernel of
``csrc/axial_lanes_fwd.cu`` through its wrapper (:func:`lanes_attn_fwd`,
:func:`flash_lanes_fwd`), which checks device, dtype, shape and contiguity
and raises on anything else. There is no fallback from a CUDA tensor to a
plain version. Each wrapper counts its launches in ``.launches``.

Only float32 is taken. The TPU kernels' blocking (``_JB_FWD``, ``Sb``,
VMEM budgets) is not ported: the kernel sizes itself for the H100.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels.build import library
from .attn_core import attend, attn_logits

LANES_MAX_SPAN = 16
FLASH_MAX_SPAN = 64
KERNEL_GP = (2, 4, 8, 16)


def _has_pos(qemb: torch.Tensor) -> bool:
    return qemb.shape[0] > 0


def _to_stripes(qkv: torch.Tensor):
    """(g, 2gp, L, S) -> q (S, g, c, L), k (S, g, c, L), v (S, g, gp, L)."""
    gp = qkv.shape[1] // 2
    c = gp // 2
    t = qkv.float().permute(3, 0, 1, 2)
    return t[:, :, :c], t[:, :, c:gp], t[:, :, gp:]


def _plain(qkv, qemb, kemb_t, vemb, sim_affine):
    has_pos = _has_pos(qemb)
    q, k, v = _to_stripes(qkv)
    kemb = kemb_t.transpose(1, 2) if has_pos else kemb_t
    logits = attn_logits(q, k, qemb, kemb, sim_affine, has_pos)
    sv, sve = attend(logits, v, vemb, has_pos)
    back = (1, 2, 3, 0)  # (S, g, gp, L) -> (g, gp, L, S)
    return logits, sv.permute(back).contiguous(), \
        sve.permute(back).contiguous()


def lanes_attn_plain(qkv, qemb, kemb_t, vemb, sim_affine):
    """Plain PyTorch version of the lanes kernel: ``(sv, sve)``."""
    _, sv, sve = _plain(qkv, qemb, kemb_t, vemb, sim_affine)
    return sv, sve


def flash_lanes_plain(qkv, qemb, kemb_t, vemb, sim_affine):
    """Plain PyTorch version of the flash kernel: ``(sv, sve, m, l)`` with
    ``m`` the row max of the logits and ``l`` the softmax denominator,
    each (g, L, S)."""
    logits, sv, sve = _plain(qkv, qemb, kemb_t, vemb, sim_affine)
    m = logits.amax(dim=-1)                              # (S, g, L)
    l = torch.exp(logits - m[..., None]).sum(dim=-1)
    return sv, sve, m.permute(1, 2, 0).contiguous(), \
        l.permute(1, 2, 0).contiguous()


def _check(qkv, qemb, kemb_t, vemb, sim_affine, max_span: int, name: str):
    """Validate what the kernel takes; returns (g, gp, L, S, has_pos)."""
    if qkv.dim() != 4:
        raise ValueError(f"{name}: qkv must be (g, 2gp, L, S), got "
                         f"{tuple(qkv.shape)}")
    g, r2, L, S = qkv.shape
    gp = r2 // 2
    c = gp // 2
    has_pos = _has_pos(qemb)
    if r2 % 2 or gp not in KERNEL_GP:
        raise ValueError(f"{name}: group planes gp={r2 / 2} not in "
                         f"{KERNEL_GP}")
    if not 1 <= L <= max_span:
        raise ValueError(f"{name}: span {L} outside 1..{max_span}")
    tables = {"qemb": (qemb, (c, L, L)), "kemb_t": (kemb_t, (c, L, L)),
              "vemb": (vemb, (gp, L, L))}
    shapes = {"qkv": (qkv, (g, r2, L, S)), "sim_affine": (sim_affine, (g, 8))}
    if has_pos:
        shapes.update(tables)
    else:
        for tname, (t, _) in tables.items():
            if t.numel():
                raise ValueError(f"{name}: {tname} must be empty when qemb is")
    for tname, (t, shape) in shapes.items():
        if t.device != qkv.device or t.device.type != "cuda":
            raise ValueError(f"{name}: {tname} must lie on qkv's CUDA "
                             f"device, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {tname} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tname} shape {tuple(t.shape)} != "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    return g, gp, L, S, has_pos


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def _zeros_like_view(t: torch.Tensor) -> torch.Tensor:
    """A zero tensor of ``t``'s shape that allocates one element."""
    return torch.zeros((), dtype=t.dtype, device=t.device).expand(t.shape)


def lanes_attn_fwd(qkv, qemb, kemb_t, vemb, sim_affine):
    """Launch the lanes kernel (spans <= 16) on CUDA tensors."""
    g, gp, L, S, has_pos = _check(qkv, qemb, kemb_t, vemb, sim_affine,
                                  LANES_MAX_SPAN, "lanes_attn_fwd")
    sv = torch.empty((g, gp, L, S), dtype=torch.float32, device=qkv.device)
    sve = torch.empty_like(sv) if has_pos else sv  # not written without pos
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = library().medt_lanes_attn_fwd(
        _ptr(qkv), _ptr(qemb), _ptr(kemb_t), _ptr(vemb), _ptr(sim_affine),
        _ptr(sv), _ptr(sve), g, gp, L, S, int(has_pos),
        ctypes.c_void_p(stream))
    _raise_on(err, "lanes_attn_fwd")
    lanes_attn_fwd.launches += 1
    return sv, (sve if has_pos else _zeros_like_view(sv))


lanes_attn_fwd.launches = 0


def flash_lanes_fwd(qkv, qemb, kemb_t, vemb, sim_affine):
    """Launch the flash kernel (spans <= 64) on CUDA tensors:
    ``(sv, sve, m, l)``."""
    g, gp, L, S, has_pos = _check(qkv, qemb, kemb_t, vemb, sim_affine,
                                  FLASH_MAX_SPAN, "flash_lanes_fwd")
    dev = qkv.device
    sv = torch.empty((g, gp, L, S), dtype=torch.float32, device=dev)
    sve = torch.empty_like(sv) if has_pos else sv
    m = torch.empty((g, L, S), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = library().medt_flash_lanes_fwd(
        _ptr(qkv), _ptr(qemb), _ptr(kemb_t), _ptr(vemb), _ptr(sim_affine),
        _ptr(sv), _ptr(sve), _ptr(m), _ptr(l), g, gp, L, S, int(has_pos),
        ctypes.c_void_p(stream))
    _raise_on(err, "flash_lanes_fwd")
    flash_lanes_fwd.launches += 1
    return sv, (sve if has_pos else _zeros_like_view(sv)), m, l


flash_lanes_fwd.launches = 0


def lanes_attn_core(qkv, qemb, kemb_t, vemb, sim_affine):
    """Spans <= 16: the kernel on CUDA tensors, the plain version on CPU."""
    if qkv.device.type == "cpu":
        return lanes_attn_plain(qkv, qemb, kemb_t, vemb, sim_affine)
    return lanes_attn_fwd(qkv, qemb, kemb_t, vemb, sim_affine)


def flash_lanes_core(qkv, qemb, kemb_t, vemb, sim_affine):
    """Spans 17..64: the kernel on CUDA tensors, the plain version on CPU."""
    if qkv.device.type == "cpu":
        sv, sve, _, _ = flash_lanes_plain(qkv, qemb, kemb_t, vemb, sim_affine)
    else:
        sv, sve, _, _ = flash_lanes_fwd(qkv, qemb, kemb_t, vemb, sim_affine)
    return sv, sve


def reset_launch_counts():
    lanes_attn_fwd.launches = 0
    flash_lanes_fwd.launches = 0


def launch_counts() -> dict:
    return {"lanes_attn_fwd": lanes_attn_fwd.launches,
            "flash_lanes_fwd": flash_lanes_fwd.launches}
