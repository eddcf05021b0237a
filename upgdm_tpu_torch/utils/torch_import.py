"""Import reference-trained checkpoints (torch state_dicts of the original
implementation) into the flax-named flat dict the port's models load.

Counterpart of ``upgdm_tpu/utils/torch_import.py``, numpy only; the key maps
and layout transforms are the JAX package's, because the port's models read
the same flax-named flat dict (``utils/weights.py`` maps it onto the torch
modules). Each wrapper's ``convert_reference_state_dict`` detects a
reference checkpoint and converts it; ``DiffusionWrapperBase.load_state_dict``
calls it first, so a reference checkpoint loads like a native one.

- NsDiff: ``model.diffussion_model.*`` (the conditional denoiser's
  ``lin1..3`` ConditionalLinear + ``lin4``/``sigma_lin`` heads),
  ``cond_pred_model.*`` (the NS-Transformer f(x): ``value_embedding.tokenConv``,
  ``attn_layers.{i}`` with ``{query,key,value,out}_projection``, 1x1 conv FFN
  ``conv1``/``conv2``, norms, decoder ``layers.{i}``, ``projection``, the
  tau/delta Projectors) and ``cond_pred_model_g.mlp.*`` (SigmaEstimation).
- TMDM: the CARD denoiser, the x-embedding and the VAE z heads.
- DiffusionTS: the Transformer under ``model.model.*``; the schedule buffers
  are recomputed, not imported.
- DiffSTG: the UGnet under ``model.*``, its construction loops mirrored so
  the shortcut pattern matches.

Layouts: torch Linear ``weight [out,in]`` -> ``kernel (in,out)``; Conv1d
``weight [out,in,k]`` -> ``(k,in,out)``; 1x1 FFN convs -> Dense kernels;
LayerNorm ``weight`` -> ``scale``. Buffers (positional encodings, masks) carry
no learned state and are skipped; ``module.`` DataParallel prefixes are
stripped. Strict mode fails listing any unmapped or missing key.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = [
    "nsdiff_reference_key_map",
    "tmdm_reference_key_map",
    "dts_reference_key_map",
    "diffstg_reference_key_map",
    "convert_reference_nsdiff_state_dict",
    "convert_reference_tmdm_state_dict",
    "convert_reference_dts_state_dict",
    "convert_reference_diffstg_state_dict",
    "looks_like_reference_nsdiff_state_dict",
]

# transforms: name -> fn(np.ndarray) -> np.ndarray
_T = {
    "linear": lambda w: np.ascontiguousarray(np.asarray(w).T),
    "conv1d": lambda w: np.ascontiguousarray(np.transpose(np.asarray(w), (2, 1, 0))),
    "ffn_conv": lambda w: np.ascontiguousarray(np.asarray(w)[..., 0].T),
    # Conv1d(T_in -> T_out, k=1) acting on the time axis -> our dense
    # time-mix kernel [T_out, T_in] (models/diffusionts_net.py::TimeMixDense)
    "time_conv": lambda w: np.ascontiguousarray(np.asarray(w)[..., 0]),
    # Conv2d (1,k) or (3,k) on height-1 inputs: only the middle kernel row
    # ever touches data (DiffSTG/ugnet.py applies them to [B*V, C, 1, T]),
    # so slice it into our 1-D kernel [k, in, out]
    "conv2d_midrow": lambda w: np.ascontiguousarray(
        np.transpose(np.asarray(w)[:, :, np.asarray(w).shape[2] // 2, :], (2, 1, 0))
    ),
    # Conv2d kernel (1,1) acting as a channel mix -> Dense kernel [in, out]
    "conv2d_1x1": lambda w: np.ascontiguousarray(np.asarray(w)[:, :, 0, 0].T),
    # ConvTranspose2d [in, out, 1, K] on height-1 inputs -> our time-axis
    # fractionally-strided correlation kernel [K, in, out] (torch's transpose
    # conv convolves with the FLIPPED kernel)
    "convtranspose2d_time": lambda w: np.ascontiguousarray(
        np.transpose(np.asarray(w)[:, :, 0, ::-1], (2, 0, 1))
    ),
    # LayerNorm([1, C]) affine [1, C] -> [C]
    "squeeze_copy": lambda w: np.ascontiguousarray(np.asarray(w).reshape(-1)),
    "copy": lambda w: np.asarray(w),
}

_SKIP_SUBSTRINGS = (".pe", "position_embedding", "temporal_embedding", "mask")


def _attention(src: str, dst: str, out: dict):
    for name in ("query", "key", "value", "out"):
        out[f"{src}.{name}_projection.weight"] = (f"{dst}.{name}.kernel", "linear")
        out[f"{src}.{name}_projection.bias"] = (f"{dst}.{name}.bias", "copy")


def _ffn_and_norms(src: str, dst: str, n_norms: int, out: dict):
    out[f"{src}.conv1.weight"] = (f"{dst}.Dense_0.kernel", "ffn_conv")
    out[f"{src}.conv1.bias"] = (f"{dst}.Dense_0.bias", "copy")
    out[f"{src}.conv2.weight"] = (f"{dst}.Dense_1.kernel", "ffn_conv")
    out[f"{src}.conv2.bias"] = (f"{dst}.Dense_1.bias", "copy")
    for j in range(n_norms):
        out[f"{src}.norm{j + 1}.weight"] = (f"{dst}.LayerNorm_{j}.scale", "copy")
        out[f"{src}.norm{j + 1}.bias"] = (f"{dst}.LayerNorm_{j}.bias", "copy")


def _projector(src: str, dst: str, p_hidden_layers: int, out: dict):
    out[f"{src}.series_conv.weight"] = (f"{dst}.series_conv_kernel", "conv1d")
    # backbone Sequential: Linear,ReLU interleaved; final Linear bias-free
    for j in range(p_hidden_layers):
        out[f"{src}.backbone.{2 * j}.weight"] = (f"{dst}.Dense_{j}.kernel", "linear")
        out[f"{src}.backbone.{2 * j}.bias"] = (f"{dst}.Dense_{j}.bias", "copy")
    out[f"{src}.backbone.{2 * p_hidden_layers}.weight"] = (
        f"{dst}.Dense_{p_hidden_layers}.kernel", "linear",
    )


def _conditional_linears(prefix: str, dst_prefix: str, heads, out: dict):
    """ConditionalGuidedModel linears (denoise.py:23-51, tmdm_model.py:23-64)."""
    for i in (1, 2, 3):
        out[f"{prefix}.lin{i}.lin.weight"] = (f"{dst_prefix}.lin{i}.Dense_0.kernel", "linear")
        out[f"{prefix}.lin{i}.lin.bias"] = (f"{dst_prefix}.lin{i}.Dense_0.bias", "copy")
        out[f"{prefix}.lin{i}.embed.weight"] = (f"{dst_prefix}.lin{i}.embed", "copy")
    for head in heads:
        out[f"{prefix}.{head}.weight"] = (f"{dst_prefix}.{head}.kernel", "linear")
        out[f"{prefix}.{head}.bias"] = (f"{dst_prefix}.{head}.bias", "copy")


def _token_embedding(src: str, dst: str, out: dict):
    out[f"{src}.value_embedding.tokenConv.weight"] = (
        f"{dst}.TokenEmbedding_0.CircularConv1d_0.Conv_0.kernel", "conv1d")


def _ns_transformer(f: str, e_layers: int, d_layers: int, p_hidden_layers: int,
                    out: dict):
    """Canonical NS-Transformer tree (mu_backbone.py:53-110 and the TMDM twin)."""
    for emb in ("enc_embedding", "dec_embedding"):
        _token_embedding(f"{f}.{emb}", f"{f}.{emb}", out)
    for i in range(e_layers):
        src = f"{f}.encoder.attn_layers.{i}"
        dst = f"{f}.encoder.NSEncoderLayer_{i}"
        _attention(f"{src}.attention", f"{dst}.AttentionLayer_0", out)
        _ffn_and_norms(src, dst, 2, out)
    out[f"{f}.encoder.norm.weight"] = (f"{f}.encoder.LayerNorm_0.scale", "copy")
    out[f"{f}.encoder.norm.bias"] = (f"{f}.encoder.LayerNorm_0.bias", "copy")
    for i in range(d_layers):
        src = f"{f}.decoder.layers.{i}"
        dst = f"{f}.decoder.NSDecoderLayer_{i}"
        _attention(f"{src}.self_attention", f"{dst}.self_attn", out)
        _attention(f"{src}.cross_attention", f"{dst}.cross_attn", out)
        _ffn_and_norms(src, dst, 3, out)
    out[f"{f}.decoder.norm.weight"] = (f"{f}.decoder.LayerNorm_0.scale", "copy")
    out[f"{f}.decoder.norm.bias"] = (f"{f}.decoder.LayerNorm_0.bias", "copy")
    out[f"{f}.decoder.projection.weight"] = (f"{f}.decoder.Dense_0.kernel", "linear")
    out[f"{f}.decoder.projection.bias"] = (f"{f}.decoder.Dense_0.bias", "copy")
    _projector(f"{f}.tau_learner", f"{f}.tau_learner", p_hidden_layers, out)
    _projector(f"{f}.delta_learner", f"{f}.delta_learner", p_hidden_layers, out)


def nsdiff_reference_key_map(e_layers: int, d_layers: int,
                             p_hidden_layers: int) -> Dict[str, tuple]:
    """torch checkpoint key -> (flax flat key, transform name)."""
    out: Dict[str, tuple] = {}
    _conditional_linears("model.diffussion_model", "model",
                         ("lin4", "sigma_lin"), out)
    # g(x) (g_backbone.py:32-41): Sequential Linear,ReLU,LN,Linear,ReLU,LN,Linear
    g = "cond_pred_model_g"
    for idx, j in ((0, 0), (3, 1), (6, 2)):
        out[f"{g}.mlp.{idx}.weight"] = (f"{g}.Dense_{j}.kernel", "linear")
        out[f"{g}.mlp.{idx}.bias"] = (f"{g}.Dense_{j}.bias", "copy")
    for idx, j in ((2, 0), (5, 1)):
        out[f"{g}.mlp.{idx}.weight"] = (f"{g}.LayerNorm_{j}.scale", "copy")
        out[f"{g}.mlp.{idx}.bias"] = (f"{g}.LayerNorm_{j}.bias", "copy")
    _ns_transformer("cond_pred_model", e_layers, d_layers, p_hidden_layers, out)
    return out


def tmdm_reference_key_map(e_layers: int, d_layers: int,
                           p_hidden_layers: int) -> Dict[str, tuple]:
    """TMDM wrapper tree (tmdm_adapter.py:68-71, TMDM.py:88-91,
    tmdm_ns_transformer.py:40-114): CARD denoiser + x-embedding on the core,
    VAE z heads on the NS-Transformer."""
    out: Dict[str, tuple] = {}
    _conditional_linears("model.diffussion_model", "model", ("lin4",), out)
    _token_embedding("model.enc_embedding", "enc_embedding", out)
    _ns_transformer("cond_pred_model", e_layers, d_layers, p_hidden_layers, out)
    for z in ("z_mean", "z_logvar", "z_out"):  # Sequential Linear,ReLU,Linear
        for idx, j in ((0, 0), (2, 1)):
            out[f"cond_pred_model.{z}.{idx}.weight"] = (
                f"cond_pred_model.{z}_{j}.kernel", "linear")
            out[f"cond_pred_model.{z}.{idx}.bias"] = (
                f"cond_pred_model.{z}_{j}.bias", "copy")
    return out


def _dts_attention(src: str, dst: str, out: dict):
    """GPT-style attention (diffusionts_transformer.py:101-160)."""
    for name in ("key", "query", "value", "proj"):
        out[f"{src}.{name}.weight"] = (f"{dst}.{name}.kernel", "linear")
        out[f"{src}.{name}.bias"] = (f"{dst}.{name}.bias", "copy")


def _dts_adanorm(src: str, dst: str, out: dict):
    out[f"{src}.linear.weight"] = (f"{dst}.Dense_0.kernel", "linear")
    out[f"{src}.linear.bias"] = (f"{dst}.Dense_0.bias", "copy")


def _dts_mlp(src: str, dst: str, out: dict):
    for idx, j in ((0, 0), (2, 1)):
        out[f"{src}.mlp.{idx}.weight"] = (f"{dst}.Dense_{j}.kernel", "linear")
        out[f"{src}.mlp.{idx}.bias"] = (f"{dst}.Dense_{j}.bias", "copy")


def dts_reference_key_map(n_layer_enc: int, n_layer_dec: int) -> Dict[str, tuple]:
    """DiffusionTS Transformer tree (diffusionts_transformer.py:381-440) ->
    our DTSTransformer (models/diffusionts_net.py).  Checkpoint keys carry the
    wrapper prefix model.model.* (DiffusionTS_model holds Diffusion_TS holds
    Transformer); schedule buffers under model.* are skipped by the caller."""
    out: Dict[str, tuple] = {}
    p = "model.model"
    out[f"{p}.emb.sequential.1.weight"] = ("model.emb.Conv_0.kernel", "conv1d")
    out[f"{p}.emb.sequential.1.bias"] = ("model.emb.Conv_0.bias", "copy")
    out[f"{p}.inverse.sequential.1.weight"] = ("model.inverse.Conv_0.kernel", "conv1d")
    out[f"{p}.inverse.sequential.1.bias"] = ("model.inverse.Conv_0.bias", "copy")
    out[f"{p}.combine_s.weight"] = ("model.combine_s.kernel", "conv1d")
    out[f"{p}.combine_m.weight"] = ("model.combine_m.kernel", "time_conv")
    out[f"{p}.pos_enc.pe"] = ("model.pos_enc.pe", "copy")
    out[f"{p}.pos_dec.pe"] = ("model.pos_dec.pe", "copy")
    for i in range(n_layer_enc):
        src, dst = f"{p}.encoder.blocks.{i}", f"model.enc_{i}"
        _dts_adanorm(f"{src}.ln1", f"{dst}.ln1", out)
        out[f"{src}.ln2.weight"] = (f"{dst}.ln2.scale", "copy")
        out[f"{src}.ln2.bias"] = (f"{dst}.ln2.bias", "copy")
        _dts_attention(f"{src}.attn", f"{dst}.FullAttention_0", out)
        _dts_mlp(src, dst, out)
    for i in range(n_layer_dec):
        src, dst = f"{p}.decoder.blocks.{i}", f"model.dec_{i}"
        _dts_adanorm(f"{src}.ln1", f"{dst}.ln1", out)
        _dts_adanorm(f"{src}.ln1_1", f"{dst}.ln1_1", out)
        out[f"{src}.ln2.weight"] = (f"{dst}.ln2.scale", "copy")
        out[f"{src}.ln2.bias"] = (f"{dst}.ln2.bias", "copy")
        _dts_attention(f"{src}.attn1", f"{dst}.FullAttention_0", out)
        _dts_attention(f"{src}.attn2", f"{dst}.CrossAttention_0", out)
        _dts_mlp(src, dst, out)
        out[f"{src}.proj.weight"] = (f"{dst}.proj.kernel", "time_conv")
        out[f"{src}.proj.bias"] = (f"{dst}.proj.bias", "copy")
        out[f"{src}.trend.trend.0.weight"] = (f"{dst}.trend.trend_conv.Conv_0.kernel", "conv1d")
        out[f"{src}.trend.trend.0.bias"] = (f"{dst}.trend.trend_conv.Conv_0.bias", "copy")
        out[f"{src}.trend.trend.3.weight"] = (f"{dst}.trend.feat_conv.kernel", "conv1d")
        out[f"{src}.trend.trend.3.bias"] = (f"{dst}.trend.feat_conv.bias", "copy")
        out[f"{src}.linear.weight"] = (f"{dst}.linear.kernel", "linear")
        out[f"{src}.linear.bias"] = (f"{dst}.linear.bias", "copy")
    return out


def _diffstg_residual(src: str, dst: str, c_in: int, c_out: int, out: dict):
    """One reference ResidualBlock (DiffSTG/ugnet.py:79-133) -> our
    models/ugnet.py::ResidualBlock.  src carries the torch '.res' level."""
    for tcn, tcn_in in (("tcn1", c_in), ("tcn2", c_out)):
        out[f"{src}.{tcn}.conv.weight"] = (f"{dst}.{tcn}.Conv_0.kernel", "conv2d_midrow")
        out[f"{src}.{tcn}.conv.bias"] = (f"{dst}.{tcn}.Conv_0.bias", "copy")
        if tcn_in != c_out:
            out[f"{src}.{tcn}.shortcut.weight"] = (f"{dst}.{tcn}.shortcut.kernel", "conv2d_1x1")
            out[f"{src}.{tcn}.shortcut.bias"] = (f"{dst}.{tcn}.shortcut.bias", "copy")
    if c_in != c_out:
        out[f"{src}.shortcut.weight"] = (f"{dst}.shortcut.kernel", "conv2d_1x1")
        out[f"{src}.shortcut.bias"] = (f"{dst}.shortcut.bias", "copy")
    out[f"{src}.t_conv.weight"] = (f"{dst}.t_conv.kernel", "conv2d_1x1")
    out[f"{src}.t_conv.bias"] = (f"{dst}.t_conv.bias", "copy")
    out[f"{src}.norm.weight"] = (f"{dst}.norm.scale", "squeeze_copy")
    out[f"{src}.norm.bias"] = (f"{dst}.norm.bias", "squeeze_copy")
    out[f"{src}.downsampling.weight"] = (f"{dst}.downsampling.Conv_0.kernel", "conv2d_midrow")
    out[f"{src}.downsampling.bias"] = (f"{dst}.downsampling.Conv_0.bias", "copy")
    out[f"{src}.upsampling.weight"] = (f"{dst}.upsampling.kernel", "convtranspose2d_time")
    out[f"{src}.upsampling.bias"] = (f"{dst}.upsampling.bias", "copy")
    # PyG GCNConv: lin.weight [out, in] (bias-free) + separate bias
    out[f"{src}.spatial.gnn.lin.weight"] = (f"{dst}.spatial.GCNConv_0.Dense_0.kernel", "linear")
    out[f"{src}.spatial.gnn.bias"] = (f"{dst}.spatial.GCNConv_0.bias", "copy")


def diffstg_reference_key_map(net_param: dict) -> Dict[str, tuple]:
    """DiffSTG UGnet tree (DiffSTG/ugnet.py:192-296) -> our models/ugnet.py.

    Mirrors the reference's U-Net construction loops exactly (channel
    multipliers x n_blocks, Downsample/Upsample between resolutions) so the
    shortcut-existence pattern matches; checkpoint keys carry the DiffSTG
    wrapper prefix model.* (graph_diffusion_model.py:114).
    """
    mults = list(net_param.get("channel_multipliers", [1, 2]))
    n_blocks = int(net_param.get("n_blocks", 2))
    d_h = int(net_param["d_h"])
    out: Dict[str, tuple] = {}
    p = "model"
    out[f"{p}.x_proj.weight"] = ("model.x_proj.kernel", "conv2d_1x1")
    out[f"{p}.x_proj.bias"] = ("model.x_proj.bias", "copy")
    out[f"{p}.out.0.weight"] = ("model.out_proj.kernel", "conv2d_1x1")
    out[f"{p}.out.0.bias"] = ("model.out_proj.bias", "copy")
    out[f"{p}.out.1.weight"] = ("model.out_time_kernel", "copy")
    out[f"{p}.out.1.bias"] = ("model.out_time_bias", "copy")

    n_res = len(mults)
    # down path
    in_ch = out_ch = d_h
    bi = 0
    for i in range(n_res):
        out_ch = in_ch * mults[i]
        for _ in range(n_blocks):
            _diffstg_residual(f"{p}.down.{bi}.res", f"model.down_{bi}", in_ch, out_ch, out)
            in_ch = out_ch
            bi += 1
        if i < n_res - 1:
            out[f"{p}.down.{bi}.conv.weight"] = (f"model.down_{bi}.conv.Conv_0.kernel", "conv2d_midrow")
            out[f"{p}.down.{bi}.conv.bias"] = (f"model.down_{bi}.conv.Conv_0.bias", "copy")
            bi += 1
    # middle
    _diffstg_residual(f"{p}.middle.res1", "model.middle_1", out_ch, out_ch, out)
    _diffstg_residual(f"{p}.middle.res2", "model.middle_2", out_ch, out_ch, out)
    # up path
    in_ch = out_ch
    bi = 0
    for i in reversed(range(n_res)):
        out_ch = in_ch
        for _ in range(n_blocks):
            _diffstg_residual(f"{p}.up.{bi}.res", f"model.up_{bi}", in_ch + out_ch, out_ch, out)
            bi += 1
        out_ch = in_ch // mults[i]
        _diffstg_residual(f"{p}.up.{bi}.res", f"model.up_{bi}", in_ch + out_ch, out_ch, out)
        in_ch = out_ch
        bi += 1
        if i > 0:
            out[f"{p}.up.{bi}.conv.weight"] = (f"model.up_{bi}.conv.kernel", "convtranspose2d_time")
            out[f"{p}.up.{bi}.conv.bias"] = (f"model.up_{bi}.conv.bias", "copy")
            bi += 1
    return out


def convert_reference_diffstg_state_dict(
    flat: Dict[str, np.ndarray], net_param: dict, strict: bool = True,
) -> Dict[str, np.ndarray]:
    """Reference torch state_dict -> our flat param dict (DiffSTG)."""
    out = _convert(flat, diffstg_reference_key_map(net_param), strict)
    return out


# Diffusion_TS schedule buffers + wrapper buffers (recomputed, not imported)
_DTS_BUFFER_PREFIXES = (
    "model.betas", "model.alphas", "model.sqrt_", "model.log_", "model.loss_weight",
    "model.posterior_", "model.one_minus_", "gt_mask",
)


def convert_reference_dts_state_dict(
    flat: Dict[str, np.ndarray], net_param: dict, strict: bool = True,
) -> Dict[str, np.ndarray]:
    """Reference torch state_dict -> our flat param dict (DiffusionTS)."""
    key_map = dts_reference_key_map(
        int(net_param.get("n_layer_enc", 1)), int(net_param.get("n_layer_dec", 2)),
    )
    flat = {
        k: v for k, v in flat.items()
        if not _strip_module(k).startswith(_DTS_BUFFER_PREFIXES)
    }
    out = _convert(flat, key_map, strict)
    # torch combine_m is bias-free (diffusionts_transformer.py:413); our
    # TimeMixDense carries a bias -> identical with zeros.  Guard on the
    # kernel's presence: under strict=False a partial checkpoint may lack
    # combine_m entirely, and the zeros bias would be meaningless anyway.
    if "model.combine_m.kernel" in out:
        out.setdefault(
            "model.combine_m.bias",
            np.zeros(np.asarray(out["model.combine_m.kernel"]).shape[0], np.float32),
        )
    return out


def _strip_module(key: str) -> str:
    while key.startswith("module."):  # DataParallel prefix (utils.py:677-679)
        key = key[len("module."):]
    return key


def looks_like_reference_nsdiff_state_dict(flat: Dict[str, np.ndarray]) -> bool:
    return any(
        _strip_module(k).startswith(("model.diffussion_model.", "cond_pred_model_g.mlp."))
        or "_projection." in k
        for k in flat
    )


def _layer_counts(net_param: dict):
    return (
        int(net_param.get("e_layers", 2)),
        int(net_param.get("d_layers", 1)),
        int(net_param.get("p_hidden_layers",
                          len(net_param.get("p_hidden_dims", [64, 64])))),
    )


def convert_reference_nsdiff_state_dict(
    flat: Dict[str, np.ndarray], net_param: dict, strict: bool = True,
    components=("model", "cond_pred_model", "cond_pred_model_g"),
) -> Dict[str, np.ndarray]:
    """Reference torch state_dict -> our flat param dict (NsDiff).

    ``components`` restricts the expected tree for the ablation variants
    (NsDiff_model.py:271-313: Guassian/cond_mean/cond_var drop f and/or g),
    whose checkpoints legitimately lack those subtrees."""
    key_map = {
        src: dst for src, dst in nsdiff_reference_key_map(*_layer_counts(net_param)).items()
        if src.split(".")[0] in components
    }
    return _convert(flat, key_map, strict)


def convert_reference_tmdm_state_dict(
    flat: Dict[str, np.ndarray], net_param: dict, strict: bool = True,
) -> Dict[str, np.ndarray]:
    """Reference torch state_dict -> our flat param dict (TMDM)."""
    return _convert(flat, tmdm_reference_key_map(*_layer_counts(net_param)), strict)


def _convert(
    flat: Dict[str, np.ndarray], key_map: Dict[str, tuple], strict: bool = True,
) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    unmapped = []
    for key, value in flat.items():
        k = _strip_module(key)
        if k in key_map:
            dst, tf = key_map[k]
            out[dst] = _T[tf](value).astype(np.float32)
        elif k in ("scaler_mean", "scaler_std"):  # our sidecar scaler entries
            out[k] = np.asarray(value)
        elif any(s in k for s in _SKIP_SUBSTRINGS):
            continue
        else:
            unmapped.append(key)
    if strict and unmapped:
        raise ValueError(
            "unrecognized reference checkpoint keys (naming drift?): "
            + ", ".join(sorted(unmapped)[:10])
        )
    missing = [k for k in key_map.values() if k[0] not in out]
    if strict and missing:
        raise ValueError(
            "reference checkpoint is missing expected parameters: "
            + ", ".join(sorted(m[0] for m in missing)[:10])
        )
    return out
