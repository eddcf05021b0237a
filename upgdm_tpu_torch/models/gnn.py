"""Dense-adjacency GNN convolutions and the name registry.

Counterpart of ``upgdm_tpu/models/gnn.py``: the reference's PyG layer
registry (gnn_conv.py:4-28) as torch modules over a dense adjacency. Node
features are [..., V, C] with an adjacency [V, V] or [..., V, V] that
broadcasts over the leading axes; every aggregation is a batched product,
and GAT/GATv2 take a neighbour-masked softmax.

Each module carries flax's parameter names, so the flat checkpoint keys are
the JAX package's (``utils/weights.py``): the auto-named ``Dense_0`` of
GCNConv, the ``lin_*`` of the PyG-named layers, ``att_src``/``att_dst``/
``att``/``bias`` as plain parameters, and GatedGraphConv's ``GRUCell_0``
with flax's six gate linears ``ir/iz/in`` (with bias) and ``hr/hz`` (without)
and ``hn`` (with). Flax infers input widths at init; here they are given:
``gnn_conv(name, in_channels, out_channels, gnn_param)``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .dropout import Dropout
from .layers import LayerNorm, Linear, promote

__all__ = ["gnn_conv", "GCNConv", "GraphConv", "SAGEConv", "GATConv", "GATv2Conv",
           "ResGatedGraphConv", "GatedGraphConv", "GRUCell", "AGNNConv", "PNAConv"]

_NEG_INF = -1e9


def _agg(adj, x):
    """Sum-aggregate neighbour features: [..., V, C] with [V, V] or [..., V, V]."""
    return torch.matmul(*promote(adj, x))


def _edge_sum(adj, msg):
    """sum_u adj[v, u] msg[v, u, :] of pairwise messages [..., V, V, C]."""
    return torch.einsum("...vu,...vuc->...vc", *promote(adj, msg))


def _eye_like(adj):
    V = adj.shape[-1]
    return torch.eye(V, dtype=adj.dtype, device=adj.device)


def _zeros_param(*shape):
    return nn.Parameter(torch.zeros(*shape))


def _glorot_param(*shape):
    """flax's glorot_uniform over a 2-D [fan_in, fan_out] shape."""
    limit = float(np.sqrt(6.0 / (shape[-2] + shape[-1])))
    return nn.Parameter(torch.empty(*shape).uniform_(-limit, limit))


class GCNConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, add_self_loops: bool = True,
                 bias: bool = True):
        super().__init__()
        self.add_self_loops = add_self_loops
        self.Dense_0 = Linear(in_channels, out_channels, bias=False)
        self.bias = _zeros_param(out_channels) if bias else None

    def forward(self, x, adj, gen=None):
        a = adj + _eye_like(adj) if self.add_self_loops else adj
        dinv = torch.rsqrt(torch.clamp(a.sum(dim=-1), min=1e-12))
        a_hat = a * dinv[..., :, None] * dinv[..., None, :]
        out = _agg(a_hat, self.Dense_0(x))
        return out + self.bias if self.bias is not None else out


class GraphConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, aggr: str = "add"):
        super().__init__()
        self.aggr = aggr
        self.lin_rel = Linear(in_channels, out_channels, bias=False)
        self.lin_root = Linear(in_channels, out_channels)

    def forward(self, x, adj, gen=None):
        msg = _agg(adj, self.lin_rel(x))
        if self.aggr == "mean":
            msg = msg / torch.clamp(adj.sum(dim=-1), min=1.0)[..., :, None]
        return msg + self.lin_root(x)


class SAGEConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, aggr: str = "mean"):
        super().__init__()
        self.aggr = aggr
        self.lin_l = Linear(in_channels, out_channels)
        self.lin_r = Linear(in_channels, out_channels, bias=False)

    def forward(self, x, adj, gen=None):
        if self.aggr == "mean":
            neigh = _agg(adj, x) / torch.clamp(adj.sum(dim=-1), min=1.0)[..., :, None]
        elif self.aggr == "max":
            big = torch.where(adj[..., :, :, None] > 0, x[..., None, :, :], _NEG_INF)
            neigh = big.amax(dim=-2)
            neigh = torch.where(adj.sum(dim=-1)[..., :, None] > 0, neigh, 0.0)
        else:
            neigh = _agg(adj, x)
        return self.lin_l(neigh) + self.lin_r(x)


def _masked_softmax(scores, a, dropout, gen):
    """Softmax over the neighbour axis -2 of [..., V, V, H] scores, with
    non-edges at -1e9 before it and zeroed after it (padded nodes have
    empty rows)."""
    edge = a[..., :, :, None] > 0
    scores = torch.where(edge, scores, _NEG_INF)
    attn = torch.softmax(scores, dim=-2)
    attn = torch.where(edge, attn, 0.0)
    return dropout(attn, gen)


class GATConv(nn.Module):
    """Multi-head graph attention; ``out_channels`` per head (the registry
    divides by ``heads``, gnn_conv.py:7)."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 1, concat: bool = True,
                 negative_slope: float = 0.2, dropout: float = 0.0,
                 add_self_loops: bool = True):
        super().__init__()
        self.H, self.C = heads, out_channels
        self.concat, self.negative_slope = concat, negative_slope
        self.add_self_loops = add_self_loops
        self.lin = Linear(in_channels, heads * out_channels, bias=False)
        self.att_src = _glorot_param(heads, out_channels)
        self.att_dst = _glorot_param(heads, out_channels)
        self.bias = _zeros_param(heads * out_channels if concat else out_channels)
        self.dropout = Dropout(dropout)

    def forward(self, x, adj, gen=None):
        a = adj + _eye_like(adj) if self.add_self_loops else adj
        h = self.lin(x)
        h = h.reshape(h.shape[:-1] + (self.H, self.C))  # [..., V, H, C]
        alpha_src = (h * self.att_src).sum(-1)  # [..., V, H]
        alpha_dst = (h * self.att_dst).sum(-1)
        # the score of edge (i <- j): leaky_relu(alpha_dst_i + alpha_src_j)
        scores = alpha_dst[..., :, None, :] + alpha_src[..., None, :, :]
        scores = F.leaky_relu(scores, self.negative_slope)
        attn = _masked_softmax(scores, a, self.dropout, gen)
        out = torch.einsum("...vuh,...uhc->...vhc", *promote(attn, h))
        if self.concat:
            out = out.reshape(out.shape[:-2] + (self.H * self.C,))
        else:
            out = out.mean(dim=-2)
        return out + self.bias


class GATv2Conv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, heads: int = 1, concat: bool = True,
                 negative_slope: float = 0.2, dropout: float = 0.0,
                 add_self_loops: bool = True):
        super().__init__()
        self.H, self.C = heads, out_channels
        self.concat, self.negative_slope = concat, negative_slope
        self.add_self_loops = add_self_loops
        self.lin_l = Linear(in_channels, heads * out_channels, bias=False)
        self.lin_r = Linear(in_channels, heads * out_channels, bias=False)
        self.att = _glorot_param(heads, out_channels)
        self.bias = _zeros_param(heads * out_channels if concat else out_channels)
        self.dropout = Dropout(dropout)

    def forward(self, x, adj, gen=None):
        a = adj + _eye_like(adj) if self.add_self_loops else adj
        hl = self.lin_l(x).reshape(x.shape[:-1] + (self.H, self.C))
        hr = self.lin_r(x).reshape(x.shape[:-1] + (self.H, self.C))
        pair = hl[..., :, None, :, :] + hr[..., None, :, :, :]  # [..., V, V, H, C]
        scores = (F.leaky_relu(pair, self.negative_slope) * self.att).sum(-1)
        attn = _masked_softmax(scores, a, self.dropout, gen)
        out = torch.einsum("...vuh,...uhc->...vhc", *promote(attn, hr))
        if self.concat:
            out = out.reshape(out.shape[:-2] + (self.H * self.C,))
        else:
            out = out.mean(dim=-2)
        return out + self.bias


class ResGatedGraphConv(nn.Module):
    """Residual gated graph conv (Bresson & Laurent 2017), PyG semantics:
    out = W1 x_i + sum_j eta_ij * (W2 x_j), eta_ij = sigmoid(W3 x_i + W4 x_j)."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 root_weight: bool = True):
        super().__init__()
        self.lin_key = Linear(in_channels, out_channels, bias=False)
        self.lin_query = Linear(in_channels, out_channels, bias=False)
        self.lin_value = Linear(in_channels, out_channels, bias=False)
        self.lin_skip = Linear(in_channels, out_channels, bias=False) if root_weight else None
        self.bias = _zeros_param(out_channels) if bias else None

    def forward(self, x, adj, gen=None):
        k = self.lin_key(x)  # W3 x_i
        q = self.lin_query(x)  # W4 x_j
        v = self.lin_value(x)  # W2 x_j
        eta = torch.sigmoid(k[..., :, None, :] + q[..., None, :, :])  # [..., V, V, C]
        out = _edge_sum(adj, eta * v[..., None, :, :])
        if self.lin_skip is not None:
            out = out + self.lin_skip(x)
        return out + self.bias if self.bias is not None else out


class GRUCell(nn.Module):
    """flax's ``GRUCell``: r = s(W_ir x + b_ir + W_hr h), z = s(W_iz x + b_iz
    + W_hz h), n = tanh(W_in x + b_in + r * (W_hn h + b_hn)), h' = (1 - z) n
    + z h. ``torch.nn.GRUCell`` packs the gates into one matrix and has
    b_hr and b_hz, which this cell does not."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        for g in ("ir", "iz", "in"):
            setattr(self, g, Linear(in_features, features))
        self.hr = Linear(features, features, bias=False)
        self.hz = Linear(features, features, bias=False)
        self.hn = Linear(features, features)

    def forward(self, h, inputs):
        r = torch.sigmoid(self.ir(inputs) + self.hr(h))
        z = torch.sigmoid(self.iz(inputs) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(inputs) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class GatedGraphConv(nn.Module):
    """GRU-based gated graph conv (Li et al. 2016), PyG semantics."""

    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 1):
        super().__init__()
        self.C, self.num_layers = out_channels, num_layers
        for i in range(num_layers):
            setattr(self, f"weight_{i}", Linear(out_channels, out_channels, bias=False))
        self.GRUCell_0 = GRUCell(out_channels, out_channels)

    def forward(self, x, adj, gen=None):
        C = self.C
        if x.shape[-1] < C:
            x = F.pad(x, (0, C - x.shape[-1]))
        h = x[..., :C]
        for i in range(self.num_layers):
            m = _agg(adj, getattr(self, f"weight_{i}")(h))
            h = self.GRUCell_0(h, m)
        return h


class AGNNConv(nn.Module):
    """Gated GraphConv with node gating (models/layer/AGNNConv.py:33-210),
    dense no-edge-feature form: h_i' = norm(U h_i + aggr_j sigma_ij * V h_j),
    sigma_ij = sigmoid(A h_i + B h_j), residual when the widths allow."""

    def __init__(self, in_channels: int, out_channels: int, aggregation: str = "sum",
                 mode: str = "residual"):
        super().__init__()
        self.aggregation, self.mode = aggregation, mode
        self.out_channels = out_channels
        for name in ("U", "V", "A", "B"):
            setattr(self, name, Linear(in_channels, out_channels))
        self.LayerNorm_0 = LayerNorm(out_channels, eps=1e-6)  # flax's default epsilon

    def forward(self, x, adj, gen=None):
        gate = torch.sigmoid(self.A(x)[..., :, None, :] + self.B(x)[..., None, :, :])
        out = _edge_sum(adj, gate * self.V(x)[..., None, :, :])
        if self.aggregation == "mean":
            out = out / torch.clamp(adj.sum(dim=-1), min=1.0)[..., :, None]
        h = torch.relu(self.LayerNorm_0(self.U(x) + out))
        if self.mode == "residual" and x.shape[-1] == self.out_channels:
            h = h + x
        return h


class PNAConv(nn.Module):
    """Principal Neighbourhood Aggregation (Corso et al. 2020), dense form:
    pairwise messages pre_nn(x_i || x_j), every aggregator, every degree
    scaler (delta = the mean log-degree of the training histogram ``deg``),
    concatenated with x_i and mapped by post_nn, per tower, then a linear
    mix (``lin``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 aggregators: Sequence[str] = ("mean", "min", "max", "std"),
                 scalers: Sequence[str] = ("identity", "amplification", "attenuation"),
                 deg: Optional[Sequence[float]] = None, towers: int = 1, pre_layers: int = 1,
                 post_layers: int = 1, divide_input: bool = False):
        super().__init__()
        if out_channels % towers:
            raise ValueError("out_channels must be divisible by towers")
        if divide_input and in_channels % towers:
            raise ValueError("in features must be divisible by towers")
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.towers, self.divide_input = towers, divide_input
        self.pre_layers, self.post_layers = pre_layers, post_layers
        f_out = out_channels // towers
        if deg is not None:
            hist = np.asarray(deg, dtype=float)
            d = np.arange(len(hist), dtype=float)
            delta = float((hist * np.log(d + 1)).sum() / max(hist.sum(), 1.0))
        else:
            delta = 1.0
        self.delta = max(delta, 1e-6)
        f_t = in_channels // towers if divide_input else in_channels
        width = f_t * (1 + len(self.aggregators) * len(self.scalers))
        for t in range(towers):
            setattr(self, f"pre_{t}_0", Linear(2 * f_t, f_t))
            for i in range(1, pre_layers):
                setattr(self, f"pre_{t}_{i}", Linear(f_t, f_t))
            setattr(self, f"post_{t}_0", Linear(width, f_out))
            for i in range(1, post_layers):
                setattr(self, f"post_{t}_{i}", Linear(f_out, f_out))
        self.lin = Linear(out_channels, out_channels)

    def forward(self, x, adj, gen=None):
        V = adj.shape[-1]
        lead = torch.broadcast_shapes(adj.shape[:-2], x.shape[:-2])
        mask = torch.broadcast_to(adj > 0, (*lead, V, V))
        n_neigh = torch.clamp(mask.sum(dim=-1), min=1)  # clamp(1) as in PyG
        log_deg = torch.log(n_neigh.to(x.dtype) + 1.0)[..., :, None]
        has_neigh = mask.any(dim=-1)[..., :, None]
        xs = torch.chunk(x, self.towers, dim=-1) if self.divide_input else [x] * self.towers

        tower_outs = []
        for t, xt in enumerate(xs):
            f_t = xt.shape[-1]
            shape = (*xt.shape[:-1], xt.shape[-2], f_t)
            pair = torch.cat([torch.broadcast_to(xt[..., :, None, :], shape),
                              torch.broadcast_to(xt[..., None, :, :], shape)], dim=-1)
            m = getattr(self, f"pre_{t}_0")(pair)
            for i in range(1, self.pre_layers):
                m = getattr(self, f"pre_{t}_{i}")(torch.relu(m))

            edge = mask[..., :, :, None]
            w = edge.to(m.dtype)
            mean = (m * w).sum(dim=-2) / n_neigh[..., :, None]
            aggs = []
            for name in self.aggregators:
                if name == "mean":
                    aggs.append(mean)
                elif name == "sum":
                    aggs.append((m * w).sum(dim=-2))
                elif name == "min":
                    aggs.append(torch.where(edge, m, torch.inf).amin(dim=-2))
                elif name == "max":
                    aggs.append(torch.where(edge, m, -torch.inf).amax(dim=-2))
                elif name in ("std", "var"):
                    sq = (m * m * w).sum(dim=-2) / n_neigh[..., :, None]
                    var = torch.clamp(sq - mean * mean, min=0.0)
                    aggs.append(torch.sqrt(var + 1e-5) if name == "std" else var)
                else:
                    raise ValueError(f"unknown aggregator: {name!r}")
            # min/max over an empty neighbourhood are +-inf: zeroed
            agg = torch.cat([torch.where(has_neigh, a, 0.0) for a in aggs], dim=-1)

            scaled = []
            for name in self.scalers:
                if name == "identity":
                    scaled.append(agg)
                elif name == "amplification":
                    scaled.append(agg * (log_deg / self.delta))
                elif name == "attenuation":
                    scaled.append(agg * (self.delta / log_deg))
                else:
                    raise ValueError(f"unknown scaler: {name!r}")
            h = getattr(self, f"post_{t}_0")(torch.cat([xt] + scaled, dim=-1))
            for i in range(1, self.post_layers):
                h = getattr(self, f"post_{t}_{i}")(torch.relu(h))
            tower_outs.append(h)
        return self.lin(torch.cat(tower_outs, dim=-1))


def gnn_conv(gnn_name: str, in_channels: int, out_channels: int,
             gnn_param: Optional[dict] = None) -> nn.Module:
    """Name -> dense conv module (registry parity with gnn_conv.py:4-28)."""
    p = dict(gnn_param or {})
    if gnn_name == "GATConv":
        heads = p.pop("heads", 1)
        p.pop("aggr", None)
        return GATConv(in_channels, out_channels // heads, heads=heads, **p)
    if gnn_name == "GATv2Conv":
        heads = p.pop("heads", 1)
        return GATv2Conv(in_channels, out_channels // heads, heads=heads, **p)
    if gnn_name == "GCNConv":
        return GCNConv(in_channels, out_channels, **p)
    if gnn_name == "SAGEConv":
        return SAGEConv(in_channels, out_channels, **p)
    if gnn_name == "GraphConv":
        return GraphConv(in_channels, out_channels, **p)
    if gnn_name == "GatedGraphConv":
        return GatedGraphConv(in_channels, out_channels, **p)
    if gnn_name == "ResGatedGraphConv":
        return ResGatedGraphConv(in_channels, out_channels, **p)
    if gnn_name == "AGNNConv":
        return AGNNConv(in_channels, out_channels, **p)
    if gnn_name == "PNAConv":
        for k in ("aggregators", "scalers"):
            if k in p:
                p[k] = tuple(p[k])
        if p.get("deg") is not None:
            p["deg"] = tuple(float(v) for v in np.asarray(p["deg"]).ravel())
        return PNAConv(in_channels, out_channels, **p)
    if gnn_name == "FGNNConv":
        from .fgnn import FGNNConv

        return FGNNConv(output_vdim=out_channels, var_dim=in_channels, **p)
    raise ValueError(f"unknown gnn layer: {gnn_name!r}")
