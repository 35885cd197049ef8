"""Plain PyTorch version of the flash-attention kernel (``csrc/flash_attn.cu``).

The CPU path of ``ops.flash_attention`` and the kernel's oracle on the card.
It follows the reference's exact-softmax oracle
(``repro/kernels/flash_attn/ref.py``) with the kernel's arithmetic: scores
from q and k taken to fp32, masked scores set to ``NEG_INF`` (not -inf),
``p = exp(s - max)`` in fp32 rounded to v's dtype before ``p . v``, which
accumulates in fp32, and the sum ``l`` of the unrounded ``p`` dividing at
the end.  Query head ``h`` reads KV head ``h // (H // KV)``.  The key
length ``Sk`` may differ from the query's ``Sq``; the causal mask keeps
``col <= row`` in absolute indices, as the TPU kernel's.  One batch
element at a time, so the fp32 score matrix is ``(H, Sq, Sk)``, never
``(B, H, Sq, Sk)``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's dtype."""
    B, S, H, hd = q.shape
    Sk = k.shape[1]
    group = H // k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    keep = None
    if causal:
        keep = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
    for b in range(B):
        qb = q[b].transpose(0, 1).float()                              # (H, S, hd)
        kb = k[b].transpose(0, 1).float().repeat_interleave(group, dim=0)
        vb = v[b].transpose(0, 1).repeat_interleave(group, dim=0)
        s = torch.matmul(qb, kb.transpose(1, 2)) * scale               # (H, Sq, Sk)
        if keep is not None:
            s = torch.where(keep, s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).float(), vb.float()) / l.clamp_min(1e-30)
        out[b] = o.to(q.dtype).transpose(0, 1)
    return out
