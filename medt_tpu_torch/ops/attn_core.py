"""The plain attention core and the affine glue around the kernels.

Port of ``medt_tpu/ops/pallas_axial_train.py``: ``attn_core_xla``
(``:330-359``) as :func:`attn_core_plain`, ``fold_train_affine`` (``:437``)
and ``pack_sim_affine`` (``:443``).

The similarity BN folds into one affine per (stack, group) before the
softmax, packed into a ``(g, 8)`` table::

    logits = qk*a[:,0] + a[:,1]  [+ qr*a[:,2] + a[:,3] + kr*a[:,4] + a[:,5]]

(rows 6..7 unused; rows 2..5 zero for the position-free "wopos" mode).
Layout here is stripe-major: q, k ``(S, g, c, L)``, v ``(S, g, gp, L)``;
tables ``(c, L, L)``/``(gp, L, L)`` shared by every group and indexed as in
the reference's ``all_emb`` (``kr`` reads ``kemb[c, j, i]``).
"""
from __future__ import annotations

import torch


def fold_train_affine(scale, bias, mean, var, eps: float = 1e-5):
    """gamma/beta + moments -> (a, b) with ``y = a*x + b``."""
    a = scale * torch.rsqrt(var + eps)
    return a, bias - mean * a


def pack_sim_affine(g: int, a, b, mode: str) -> torch.Tensor:
    """Pack per-stack affines into the kernels' ``(g, 8)`` layout.

    ``a``/``b`` are ``(3, g)`` for the full/gated modes or ``(g,)`` for
    ``"wopos"`` (rows 2..5 stay zero). Differentiable in ``a`` and ``b``."""
    a, b = a.float(), b.float()
    if mode == "wopos":
        cols = [a, b] + [torch.zeros_like(a)] * 6
    else:
        cols = [t for row in range(3) for t in (a[row], b[row])]
        cols += [torch.zeros_like(a[0])] * 2
    return torch.stack(cols, dim=1)


def attn_logits(q, k, qemb, kemb, sim_affine, has_pos: bool = True):
    """BN-folded similarity logits ``(S, g, L_query, L_key)``."""
    a = sim_affine[:, :, None, None]  # (g, 8, 1, 1)
    qk = torch.einsum("sgci,sgcj->sgij", q, k)
    logits = qk * a[:, 0] + a[:, 1]
    if has_pos:
        qr = torch.einsum("sgci,cij->sgij", q, qemb)
        kr = torch.einsum("sgcj,cji->sgij", k, kemb)
        logits = logits + (qr * a[:, 2] + a[:, 3]) + (kr * a[:, 4] + a[:, 5])
    return logits


def attend(logits, v, vemb, has_pos: bool = True):
    """Softmax over keys, then ``sv = sim @ v`` and ``sve = sim @ vemb``,
    each ``(S, g, gp, L)``; ``sve`` is zero without positions."""
    sim = torch.softmax(logits, dim=-1)
    sv = torch.einsum("sgij,sgpj->sgpi", sim, v)
    if not has_pos:
        return sv, torch.zeros_like(sv)
    sve = torch.einsum("sgij,pij->sgpi", sim, vemb)
    return sv, sve


def attn_core_plain(q, k, v, qemb, kemb, vemb, sim_affine,
                    has_pos: bool = True):
    """Plain PyTorch twin of ``attn_core_xla``: ``(sv, sve)``."""
    return attend(attn_logits(q, k, qemb, kemb, sim_affine, has_pos),
                  v, vemb, has_pos)
