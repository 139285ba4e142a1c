"""EquiformerV2 (arXiv:2306.12059) — eSCN-style equivariant graph attention.

The O(L⁶) Clebsch-Gordan tensor product is replaced (as in eSCN /
EquiformerV2) by rotating each edge's features into a frame aligned with
the edge axis, where the tensor product collapses to SO(2) convolutions
over the azimuthal index m, truncated at ``m_max``.  The JAX package's
``models/gnn/equiformer_v2.py``:

Wigner little-d matrices use the exact spectral form
d^l(β) = Re[P_l diag(e^{-imβ}) P_l†] with P_l = T_l U_l (real-basis
transform × eigenvectors of J_y), so that

    d^l(β)[e] = Σ_m cos(m·β_e)·A_l[m] + sin(m·β_e)·B_l[m]

against small constant tensors; z-rotations use the same machinery with
P_l = T_l.  The constants are the JAX module's, computed in numpy
(complex ``np.linalg.eigh``, cast to f32) and uploaded once a device:
``torch.linalg.eigh`` picks other eigenvector phases, hence other
constants.

Per layer: rotate source features to the edge frame → SO(2) conv
(m=0 full l-mix; |m|≤m_max complex-pair mixes) modulated by an
edge-distance filter → multi-head attention logits from the m=0 part →
soft-capped exp, summed per destination → rotate back → scatter-sum →
equivariant RMS norm + gated nonlinearity + residual.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device
from ..common import dense_init
from .common import (GraphBatch, chunked_scatter_sum, edge_count, extend,
                     gather_nodes, graph_readout, mlp, mlp_init,
                     n_edge_chunks, scatter_sum)
from .schnet import rbf_expand, regression_or_nll


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 64
    cutoff: float = 10.0
    d_in: int = 0
    n_atom_types: int = 100
    n_targets: int = 1
    edge_chunk: int = 0
    # "arbitrary" | "dst_ranged": edges bucketed into contiguous
    # destination ranges (``data.graphs.bucket_edges_by_dst``), each chunk
    # writing one node slice
    edge_layout: str = "arbitrary"
    logit_cap: float = 5.0      # soft-cap => chunk-safe exp (no max pass)
    dtype: Any = torch.float32

    @property
    def n_coef(self) -> int:
        return (self.l_max + 1) ** 2


# ---------------------------------------------------------------------------
# Wigner rotation constants (numpy, cached per l_max)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _rotation_constants(l_max: int):
    """Per l: (A, B) with d^l(β) = Σ_m cos(mβ)A[m] + sin(mβ)B[m], and the
    analogous (Az, Bz) for z-rotations. All real f32, shapes [2l+1, D, D]."""
    out = []
    for l in range(l_max + 1):
        d = 2 * l + 1
        m = np.arange(-l, l + 1)
        # J_y in the complex |l,m> basis.
        jp = np.zeros((d, d), complex)   # J+ |m> = c+ |m+1>
        for i, mm in enumerate(m[:-1]):
            jp[i + 1, i] = np.sqrt(l * (l + 1) - mm * (mm + 1))
        jm = jp.conj().T
        jy = (jp - jm) / 2j
        evals, u = np.linalg.eigh(jy)    # evals ≈ -l..l
        # Real SH basis transform T (rows: real index m'=-l..l).
        t = np.zeros((d, d), complex)
        for i, mm in enumerate(m):
            j_pos, j_neg = l + abs(mm), l - abs(mm)
            if mm == 0:
                t[i, l] = 1.0
            elif mm > 0:
                t[i, j_pos] = (-1) ** mm / np.sqrt(2)
                t[i, j_neg] = 1 / np.sqrt(2)
            else:
                t[i, j_pos] = 1j * (-1) ** abs(mm) / np.sqrt(2) * -1
                t[i, j_neg] = 1j / np.sqrt(2)
        # d(β) = T U diag(e^{-i λ β}) (T U)^† ; λ = eigenvalue.
        p = t @ u
        a = np.empty((d, d, d), np.float32)
        b = np.empty((d, d, d), np.float32)
        for k in range(d):
            outer = np.outer(p[:, k], p[:, k].conj())
            a[k] = outer.real.astype(np.float32)
            b[k] = outer.imag.astype(np.float32)
        lam = evals.astype(np.float32)   # multipliers for β
        # z-rotation: same with P = T, eigenvalues = m.
        az = np.empty((d, d, d), np.float32)
        bz = np.empty((d, d, d), np.float32)
        for k in range(d):
            outer = np.outer(t[:, k], t[:, k].conj())
            az[k] = outer.real.astype(np.float32)
            bz[k] = outer.imag.astype(np.float32)
        lamz = m.astype(np.float32)
        out.append((a, b, lam, az, bz, lamz))
    return out


@functools.lru_cache(maxsize=8)
def _rotation_tensors(l_max: int, device: torch.device):
    """:func:`_rotation_constants` on ``device``: per l, (A, B) reshaped
    to [D, D*D] for one matrix product, λ, and the same for z."""
    out = []
    for a, b, lam, az, bz, lamz in _rotation_constants(l_max):
        d = lam.shape[0]
        t = lambda v: torch.from_numpy(v).to(device)  # noqa: E731
        out.append((t(a).reshape(d, d * d), t(b).reshape(d, d * d), t(lam),
                    t(az).reshape(d, d * d), t(bz).reshape(d, d * d),
                    t(lamz)))
    return out


def _edge_rotations(vec: torch.Tensor, l_max: int) -> List[torch.Tensor]:
    """Per l: R_l [E, D, D] rotating each edge's frame so the edge direction
    lies along +z:  R = d(-θ) · z(-φ)."""
    x, y, z = vec[:, 0], vec[:, 1], vec[:, 2]
    r = torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-12))
    theta = torch.arccos(torch.clamp(z / r, -1.0, 1.0))
    phi = torch.atan2(y, x)
    e = vec.shape[0]
    rots = []
    for a, b, lam, az, bz, lamz in _rotation_tensors(l_max, vec.device):
        d = lam.shape[0]
        cb = torch.cos(lam[None, :] * (-theta[:, None]))
        sb = torch.sin(lam[None, :] * (-theta[:, None]))
        d_beta = (cb @ a + sb @ b).reshape(e, d, d)
        ca = torch.cos(lamz[None, :] * (-phi[:, None]))
        sa = torch.sin(lamz[None, :] * (-phi[:, None]))
        d_alpha = (ca @ az + sa @ bz).reshape(e, d, d)
        rots.append(torch.bmm(d_beta, d_alpha))
    return rots


def _block_apply(rots, feats: torch.Tensor, l_max: int,
                 transpose: bool = False) -> torch.Tensor:
    """feats [E, n_coef, C]; apply block-diag rotation per l."""
    outs = []
    for l in range(l_max + 1):
        lo = l * l
        r = rots[l].transpose(1, 2) if transpose else rots[l]
        outs.append(torch.bmm(r, feats[:, lo: lo + 2 * l + 1]))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _so2_shapes(cfg: EquiformerV2Config):
    """Row counts feeding each m-channel of the SO(2) conv."""
    rows = {0: cfg.l_max + 1}
    for m in range(1, cfg.m_max + 1):
        rows[m] = cfg.l_max + 1 - m
    return rows


def init_params(cfg: EquiformerV2Config,
                generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, Any]:
    """The JAX module's tree and laws, from ``generator`` on ``device``
    (default ``cuda``; default seed 0)."""
    device = resolve_device(device)
    gen = (torch.Generator(device=device).manual_seed(0)
           if generator is None else generator)
    dense = functools.partial(dense_init, gen, dtype=cfg.dtype, device=device)
    c = cfg.d_hidden
    rows = _so2_shapes(cfg)
    params: Dict[str, Any] = {
        "embed": dense((max(cfg.n_atom_types, cfg.d_in, 1), c)),
        "head": mlp_init(gen, [c, c, cfg.n_targets], cfg.dtype, device),
    }
    layers = []
    for _ in range(cfg.n_layers):
        lp = {
            "w0": dense((rows[0] * c, rows[0] * c)),
            "filter": mlp_init(gen, [cfg.n_rbf, c, c], cfg.dtype, device),
            "attn": dense((c, cfg.n_heads)),
            "gate": dense((c, c)),
            "self": [dense((c, c)) for _ in range(cfg.l_max + 1)],
        }
        for m in range(1, cfg.m_max + 1):
            lp[f"w{m}r"] = dense((rows[m] * c, rows[m] * c))
            lp[f"w{m}i"] = dense((rows[m] * c, rows[m] * c))
        layers.append(lp)
    params["layers"] = layers
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _m_index(l_max: int, m: int, sign: int) -> np.ndarray:
    """Coefficient rows (l ≥ |m|) of azimuthal index ±m, real basis."""
    return np.array([l * l + l + sign * m for l in range(abs(m), l_max + 1)],
                    np.int32)


@functools.lru_cache(maxsize=64)
def _index(l_max: int, m: int, sign: int, device: torch.device
           ) -> torch.Tensor:
    return torch.from_numpy(_m_index(l_max, m, sign).astype(np.int64)).to(
        device)


@functools.lru_cache(maxsize=16)
def _so2_rows(l_max: int, m_max: int, device: torch.device) -> torch.Tensor:
    """The rows the SO(2) conv writes, in the order of its pieces: m=0,
    then +m and -m for each m up to ``m_max``."""
    idx = [_m_index(l_max, 0, +1)]
    for m in range(1, m_max + 1):
        idx += [_m_index(l_max, m, +1), _m_index(l_max, m, -1)]
    return torch.from_numpy(np.concatenate(idx).astype(np.int64)).to(device)


def _so2_conv(feats: torch.Tensor, lp, cfg: EquiformerV2Config
              ) -> torch.Tensor:
    """feats [E, n_coef, C] in edge-aligned frames -> same shape out.  The
    JAX function's ``out.at[:, idx].set(...)`` writes disjoint rows, so
    its pieces go in with one out-of-place ``index_copy``; rows with
    |m| > m_max stay zero (the eSCN truncation)."""
    e, dev = feats.shape[0], feats.device
    c = cfg.d_hidden
    # m = 0: dense mix across (l, channel).
    idx0 = _index(cfg.l_max, 0, +1, dev)
    x0 = feats.index_select(1, idx0).reshape(e, -1)
    pieces = [(x0 @ lp["w0"]).reshape(e, len(idx0), c)]
    # 0 < m <= m_max: SO(2)-equivariant complex pair mixing.
    for m in range(1, cfg.m_max + 1):
        ip = _index(cfg.l_max, m, +1, dev)
        im = _index(cfg.l_max, m, -1, dev)
        xr = feats.index_select(1, ip).reshape(e, -1)
        xi = feats.index_select(1, im).reshape(e, -1)
        yr = xr @ lp[f"w{m}r"] - xi @ lp[f"w{m}i"]
        yi = xr @ lp[f"w{m}i"] + xi @ lp[f"w{m}r"]
        pieces += [yr.reshape(e, len(ip), c), yi.reshape(e, len(im), c)]
    return torch.zeros_like(feats).index_copy(
        1, _so2_rows(cfg.l_max, cfg.m_max, dev), torch.cat(pieces, dim=1))


def _equiv_norm(x: torch.Tensor, l_max: int) -> torch.Tensor:
    """RMS over (m, channel) per l block, per node."""
    outs = []
    for l in range(l_max + 1):
        lo = l * l
        blk = x[:, lo: lo + 2 * l + 1]
        rms = torch.sqrt(torch.mean(torch.square(blk), dim=(1, 2),
                                    keepdim=True) + 1e-6)
        outs.append(blk / rms)
    return torch.cat(outs, dim=1)


def _edge_message(xe: torch.Tensor, lp, cfg: EquiformerV2Config,
                  src: torch.Tensor, vec: torch.Tensor,
                  capped_only: bool = False):
    """Per-edge pipeline over ``xe`` (the node features with the
    sentinel's zero row appended): gather → rotate → SO(2) conv (m=0 only
    when ``capped_only``) → distance filter → soft-capped attention
    logits."""
    dist = torch.sqrt(torch.clamp(torch.sum(vec * vec, dim=-1), min=1e-12))
    rots = _edge_rotations(vec, cfg.l_max)
    rbf = rbf_expand(dist, cfg)
    src_f = xe.index_select(0, src)                          # [e, 49, C]
    f_edge = _block_apply(rots, src_f, cfg.l_max)
    filt = mlp(rbf, lp["filter"], act=F.silu)                # [e, C]
    e = f_edge.shape[0]
    if capped_only:
        # m=0 rows only — enough for the attention logits.
        idx0 = _index(cfg.l_max, 0, +1, vec.device)
        x0 = f_edge.index_select(1, idx0).reshape(e, -1)
        y0 = (x0 @ lp["w0"]).reshape(e, len(idx0), cfg.d_hidden)
        logits = (y0[:, 0] * filt) @ lp["attn"]
    else:
        msg = _so2_conv(f_edge, lp, cfg) * filt[:, None, :]
        logits = msg[:, 0] @ lp["attn"]
    cap = cfg.logit_cap
    logits = cap * torch.tanh(logits / cap)                  # soft-cap
    if capped_only:
        return logits
    return msg, logits, rots


def forward(params, g: GraphBatch, cfg: EquiformerV2Config) -> torch.Tensor:
    n, c = g.n_nodes, cfg.d_hidden
    per_head = c // cfg.n_heads
    vec = g.edge_feat.float().reshape(-1, 3)
    n_chunks = n_edge_chunks(edge_count(g), cfg.edge_chunk)

    if cfg.d_in == 0:
        x0 = params["embed"].index_select(0, g.node_feat.long())
    else:
        x0 = g.node_feat.to(cfg.dtype) @ params["embed"][: cfg.d_in]
    x = torch.cat([x0[:, None], x0.new_zeros((x0.shape[0], cfg.n_coef - 1,
                                              c))], dim=1)

    # under a mesh x is this rank's node block: the edges read the whole
    # (gathered) features and softmax denominators
    def layer_fn(x, lp):
        xe = extend(gather_nodes(x))
        if n_chunks == 1:
            msg, logits, rots = _edge_message(xe, lp, cfg, g.src, vec)
            denom = scatter_sum(torch.exp(logits), g.dst, n)     # [N, H]
            alpha = torch.exp(logits) / extend(
                torch.clamp(gather_nodes(denom), min=1e-30),
                1.0).index_select(0, g.dst)
            # jnp.repeat spreads each head over its channels
            alpha = torch.repeat_interleave(alpha, per_head, dim=-1)
            msg = msg * alpha[:, None, :]
            msg = _block_apply(rots, msg, cfg.l_max, transpose=True)
            agg = scatter_sum(msg, g.dst, n)
        else:
            ranged = cfg.edge_layout == "dst_ranged"
            # pass 1: soft-capped exp-sum per destination (m=0 conv only)
            denom = chunked_scatter_sum(
                lambda s, d, v: (torch.exp(_edge_message(
                    xe, lp, cfg, s, v, capped_only=True)), d),
                n_chunks, (g.src, g.dst, vec), n, (cfg.n_heads,),
                torch.float32, dst_ranged=ranged)
            denom_e = extend(torch.clamp(gather_nodes(denom), min=1e-30),
                             1.0)

            # pass 2: full message, normalized, rotated back, scattered
            def edge_op(s, d, v):
                m, lo, rots_c = _edge_message(xe, lp, cfg, s, v)
                al = torch.exp(lo) / denom_e.index_select(0, d)
                al = torch.repeat_interleave(al, per_head, dim=-1)
                m = m * al[:, None, :]
                return _block_apply(rots_c, m, cfg.l_max, transpose=True), d

            agg = chunked_scatter_sum(edge_op, n_chunks,
                                      (g.src, g.dst, vec), n,
                                      (cfg.n_coef, c), x.dtype,
                                      dst_ranged=ranged)
        agg = _equiv_norm(agg, cfg.l_max)
        # node update: per-l channel mix + scalar-gated nonlinearity
        up = torch.cat([agg[:, l * l: l * l + 2 * l + 1] @ lp["self"][l]
                        for l in range(cfg.l_max + 1)], dim=1)
        gate = torch.sigmoid(up[:, 0] @ lp["gate"])          # [N, C]
        scal = F.silu(up[:, :1])
        rest = up[:, 1:] * gate[:, None, :]
        return x + torch.cat([scal, rest], dim=1)

    # No layer-level remat: the JAX module measured it and refuted it
    # (the backward recompute re-runs both chunk passes).
    for lp in params["layers"]:
        x = layer_fn(x, lp)
    return x


def predict(params, g: GraphBatch, cfg: EquiformerV2Config) -> torch.Tensor:
    x = forward(params, g, cfg)
    inv = mlp(x[:, 0], params["head"], act=F.silu)           # invariant head
    if g.graph_ids is None:
        return inv
    return graph_readout(inv, g.graph_ids, g.n_graphs, op="mean")


def loss_fn(params, g: GraphBatch, cfg: EquiformerV2Config) -> torch.Tensor:
    return regression_or_nll(predict(params, g, cfg), g)
