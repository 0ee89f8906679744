"""State-space duality ops (counterpart of adnm_tpu/ops/ssd.py).

Only the non-causal linear-attention dual is ported: the mixer's default
path. It is two batched matrix products, computed outside any kernel in
the JAX package too.
"""

from __future__ import annotations

import torch


def linear_attn_dual_seqminor(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
) -> torch.Tensor:
    """``y = C^T (B (x * dA)^T) + x * D`` in the sequence-minor layout.

    x: (B, H, P, L); dt: (B, H, L) already softplus'd; A, D: (H,);
    B, C: (B, N, L) shared across heads. Returns (B, H, P, L).
    """
    b, h, p, l = x.shape
    # A is negative and every reference mixer keeps ssd_positive_dA=True,
    # so dA = -(dt * A) >= 0.
    dA = -(dt * A[None, :, None])
    v = (x * dA[:, :, None, :]).reshape(b, h * p, l)
    kv = torch.bmm(B, v.transpose(1, 2))  # (B, N, H*P)
    y = torch.bmm(kv.transpose(1, 2), C).reshape(b, h, p, l)
    return y + x * D[None, :, None, None]
