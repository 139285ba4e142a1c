"""Plain PyTorch version of flash decoding: full-softmax one-token GQA."""
import functools

import torch


@functools.lru_cache(maxsize=None)
def q_scale(dh: int, dtype: torch.dtype) -> float:
    """``dh ** -0.5`` rounded to ``dtype``.  JAX multiplies a bf16 ``q``
    by a weakly typed Python scalar, which it first rounds to bf16;
    torch would keep the scalar in f32.  Multiplying by the rounded
    value gives JAX's bits in both dtypes."""
    return torch.tensor(dh ** -0.5, dtype=dtype).item()


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: int) -> torch.Tensor:
    """q: [B, H, dh]; caches: [B, S, Kh, dh]; positions >= kv_len masked.

    Returns [B, H, dh] f32.  ``q`` is scaled by ``dh ** -0.5`` in its
    own dtype; scores, probabilities and the PV product are f32.
    """
    b, h, dh = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, dh) * q_scale(dh, q.dtype)
    sc = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    mask = torch.arange(s, device=q.device) < kv_len
    sc = sc.masked_fill(~mask, float("-inf"))
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, h, dh)
