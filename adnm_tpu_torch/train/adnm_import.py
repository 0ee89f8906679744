"""Torch state_dict importer for the flagship ADNM-UNet (counterpart of
adnm_tpu/train/adnm_import.py).

Maps the reference VisionMamba state_dict (reference: models/ADNMUNet.py
module tree + models/model_untils.py submodules + models/ADNssd.py
mixers) onto the JAX-layout parameter tree, which
``adnm_tpu_torch.convert.from_jax_params`` then loads into the port's
model; ``export_adnm_state_dict`` goes the other way, from
``convert.to_jax_params``. The ADN-SSD mixers'
even/odd channel interleave is undone with the explicit permutations of
``adnssd_mixer_permutations``.

Reference-only parameters with no effect on the forward (Mamba2
scale/shift ADNssd.py:227-228, WTLayer gama4, EncoderToDecoder
ffd31/act_func31/conv33, the constant wt/iwt filter banks, and the dead
e2ds 3..6 unless the model computes them, ``compute_dead_features=True``)
are ignored on import. The reference wires no MLA, so no reference file
holds one.

The helpers below are the port's own copies of those of
adnm_tpu/train/torch_import.py.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _conv_w(t: np.ndarray) -> np.ndarray:
    """torch conv weight (O, I, kh, kw) -> HWIO (kh, kw, I, O)."""
    return np.transpose(t, (2, 3, 1, 0))


def _conv_w_inv(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1))


def _lin_w(t: np.ndarray) -> np.ndarray:
    """torch Linear (out, in) <-> Dense kernel (in, out)."""
    return np.transpose(t, (1, 0))


def _deconv_w(t: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (in, out, kh, kw) -> HWIO (kh, kw, in, out)."""
    return np.transpose(t, (2, 3, 0, 1))


def _set(tree: dict, dotted: str, value):
    parts = dotted.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def adnssd_mixer_permutations(d_model: int, headdim: int, ngroups: int = 2, d_state: int = 16,
                              expand: int = 2):
    """Channel permutations relating the contiguous ADN-SSD layout to the
    reference's even/odd interleave (reference: models/ADNssd.py:329-386).

    Returns (xbc_perm, head_perm) with
      ours_xBC[j] == reference_xBC[xbc_perm[j]]
      ours_dt[h]  == reference_dt[head_perm[h]]   (same for A_log, D, dt_bias)
    """
    d_inner = expand * d_model
    gN = ngroups * d_state
    conv_dim = d_inner + 2 * gN
    half = conv_dim // 2
    qx = d_inner // 4
    qbc = gN // 2
    perm = np.zeros(conv_dim, np.int64)
    # path1 ("even"): ours[:half] = reference even channels
    perm[:half] = 2 * np.arange(half)
    # path2 quarters [x2a | x2b | bc2a | bc2b] == [x_oe | x_oo | bc_oe | bc_oo]
    base = half
    perm[base: base + qx] = 1 + 4 * np.arange(qx)                        # x_oe = odd[::2][:qx]
    perm[base + qx: base + 2 * qx] = 3 + 4 * np.arange(qx)               # x_oo = odd[1::2][:qx]
    perm[base + 2 * qx: base + 2 * qx + qbc] = 1 + 4 * (qx + np.arange(qbc))    # bc_oe
    perm[base + 2 * qx + qbc:] = 3 + 4 * (qx + np.arange(qbc))           # bc_oo
    nheads = d_inner // headdim
    hh = nheads // 2
    head_perm = np.concatenate([2 * np.arange(hh), 2 * np.arange(hh) + 1])
    return perm, head_perm


class _Map:
    def __init__(self):
        self.entries: Dict[str, Tuple[str, str, tuple]] = {}

    def add(self, tname, ours, kind, extra=()):
        assert tname not in self.entries, tname
        self.entries[tname] = (ours, kind, extra)

    # --- entries per module (torch prefix tp, our prefix op) -------------

    def wtconv2d(self, tp, op, levels, bias):
        self.add(f"{tp}.base_conv.weight", f"{op}/base_conv/kernel", "conv_w")
        if bias:
            self.add(f"{tp}.base_conv.bias", f"{op}/base_conv/bias", "bias")
        self.add(f"{tp}.base_scale.weight", f"{op}/base_scale", "vec4d")
        for i in range(levels):
            self.add(f"{tp}.wavelet_convs.{i}.weight", f"{op}/wavelet_conv{i}/kernel", "conv_w")
            self.add(f"{tp}.wavelet_scale.{i}.weight", f"{op}/wavelet_scale{i}", "vec4d")

    def wtconvlayer(self, tp, op, levels, bias, norm):
        self.wtconv2d(f"{tp}.conv", f"{op}/conv", levels, bias)
        if norm:
            self.add(f"{tp}.scale", f"{op}/scale", "scalar")
            self.add(f"{tp}.shift", f"{op}/shift", "scalar")

    def convlayer(self, tp, op, bias=True, norm=False, swish_act=False):
        self.add(f"{tp}.conv.weight", f"{op}/conv/kernel", "conv_w")
        if bias:
            self.add(f"{tp}.conv.bias", f"{op}/conv/bias", "bias")
        if norm:
            self.add(f"{tp}.scale", f"{op}/scale", "scalar")
            self.add(f"{tp}.shift", f"{op}/shift", "scalar")
        if swish_act:
            self.add(f"{tp}.act.beta", f"{op}/swish_act/beta", "scalar")

    def mlp(self, tp, op):
        for fc in ("fc1", "fc2"):
            self.add(f"{tp}.{fc}.weight", f"{op}/{fc}/kernel", "lin_w")
            self.add(f"{tp}.{fc}.bias", f"{op}/{fc}/bias", "bias")

    def feedforward(self, tp, op):
        for sub in ("project_in", "dwconv", "project_out"):
            self.convlayer(f"{tp}.{sub}", f"{op}/{sub}")

    def convffd(self, tp, op):
        self.add(f"{tp}.in_proj.weight", f"{op}/in_proj/kernel", "lin_w")
        self.add(f"{tp}.in_proj.bias", f"{op}/in_proj/bias", "bias")
        self.convlayer(f"{tp}.dw_conv", f"{op}/dw_conv")
        self.add(f"{tp}.out_proj.weight", f"{op}/out_proj/kernel", "lin_w")
        self.add(f"{tp}.out_proj.bias", f"{op}/out_proj/bias", "bias")

    def gate(self, tp, op):
        self.add(f"{tp}.threshold", f"{op}/threshold", "scalar")
        self.add(f"{tp}.enhance", f"{op}/enhance", "scalar")

    def scalars(self, tp, op, names):
        for nm in names:
            self.add(f"{tp}.{nm}", f"{op}/{nm}", "scalar")

    def groupnorm(self, tp, op):
        """Affine GroupNorm params, present only when the model is built
        with InstanceNorm=False (reference: model_untils.py:284,371,741,
        814 — nn.GroupNorm(4, c) has affine weight/bias, nn.InstanceNorm2d
        does not)."""
        self.add(f"{tp}.norm.weight", f"{op}/GroupNorm_0/weight", "bias")
        self.add(f"{tp}.norm.bias", f"{op}/GroupNorm_0/bias", "bias")

    def patch_embed(self, tp, op, levels, instance_norm=True):
        self.add(f"{tp}.gamma", f"{op}/gamma", "bias")
        self.wtconvlayer(f"{tp}.conv1.0", f"{op}/conv1", levels, bias=False, norm=False)
        self.convlayer(f"{tp}.conv2.0", f"{op}/conv2", bias=False)
        self.wtconvlayer(f"{tp}.conv3.0", f"{op}/conv3", levels, bias=False, norm=True)
        if not instance_norm:
            self.groupnorm(f"{tp}.conv3.0", f"{op}/conv3")
        self.scalars(tp, op, ("alpha1", "beta1", "alpha2", "beta2"))

    def wtlayer(self, tp, op, levels, instance_norm=True):
        self.wtconvlayer(f"{tp}.wtconv", f"{op}/wtconv", levels, bias=True, norm=True)
        if not instance_norm:
            self.groupnorm(f"{tp}.wtconv", f"{op}/wtconv")
        self.convlayer(f"{tp}.conv", f"{op}/conv")
        self.mlp(f"{tp}.mlp", f"{op}/mlp")
        self.add(f"{tp}.gamma", f"{op}/gamma", "bias")
        self.scalars(tp, op, ("alpha", "beta", "gama1", "gama2", "gama3"))
        # reference gama4 exists but is dead (model_untils.py:408) — ignored

    def mamba2(self, tp, op, d_model, headdim):
        self.add(f"{tp}.in_proj.weight", f"{op}/in_proj/kernel", "mixer_in_proj", (d_model, headdim))
        self.add(f"{tp}.conv2d.weight", f"{op}/conv2d/kernel", "conv_w")
        self.add(f"{tp}.conv2d_z.weight", f"{op}/conv2d_z/kernel", "conv_w")
        for t_nm, o_nm in (
            ("conv_31_x1", "conv_x1_a"), ("conv_13_x1", "conv_x1_b"),
            ("conv_13_x2", "conv_x2_a"), ("conv_31_x2", "conv_x2_b"),
            ("conv_13_bc1", "conv_bc1_a"), ("conv_31_bc1", "conv_bc1_b"),
            ("conv_31_bc2", "conv_bc2_a"), ("conv_13_bc2", "conv_bc2_b"),
        ):
            self.add(f"{tp}.{t_nm}.weight", f"{op}/{o_nm}/kernel", "conv_w")
        for nm in ("dt_bias", "A_log", "D"):
            self.add(f"{tp}.{nm}", f"{op}/{nm}", "mixer_head_vec", (d_model, headdim))
        self.add(f"{tp}.norm.weight", f"{op}/norm/scale", "bias")
        self.add(f"{tp}.norm.bias", f"{op}/norm/bias", "bias")
        self.scalars(tp, op, ("alpha1", "alpha2"))
        self.add(f"{tp}.out_proj.weight", f"{op}/out_proj/kernel", "lin_w")
        # reference scale/shift (ADNssd.py:227-228) are dead — ignored

    def block(self, tp, op, dim, out_dim, headdim, num_layers=1):
        self.scalars(tp, op, ("alpha1", "alpha2", "alpha3", "alpha4"))
        for nm in ("beta1", "beta2", "beta3", "beta4"):
            self.add(f"{tp}.{nm}", f"{op}/{nm}", "bias")
        for i in range(num_layers):
            self.mamba2(f"{tp}.mixer_layers.{i}", f"{op}/mixer_{i}", dim, headdim)
            self.add(f"{tp}.norm1_layers.{i}.weight", f"{op}/norm1_{i}/weight", "bias")
            self.add(f"{tp}.norm2_layers.{i}.weight", f"{op}/norm2_{i}/weight", "bias")
            self.feedforward(f"{tp}.ffns.{i}", f"{op}/ffn_{i}")
            for nm in ("scale1", "shift1", "scale2", "shift2"):
                self.add(f"{tp}.{nm}.{i}", f"{op}/{nm}_{i}", "scalar")
        self.add(f"{tp}.gamma", f"{op}/gamma", "bias")
        if dim != out_dim:
            self.add(f"{tp}.out_proj.weight", f"{op}/out_proj/kernel", "lin_w")
            self.add(f"{tp}.out_proj.bias", f"{op}/out_proj/bias", "bias")

    def attention(self, tp, op, dim, out_dim):
        self.scalars(tp, op, ("alpha1", "alpha2", "alpha3", "alpha4",
                              "beta1", "beta2", "beta3", "beta4",
                              "attn_scale1", "attn_shift1", "attn_scale2", "attn_shift2"))
        self.add(f"{tp}.attn_norm1.weight", f"{op}/attn_norm1/weight", "bias")
        self.add(f"{tp}.attn_norm2.weight", f"{op}/attn_norm2/weight", "bias")
        self.add(f"{tp}.attn_layer.to_qkv.weight", f"{op}/attn_layer/to_qkv/kernel", "lin_w")
        self.add(f"{tp}.attn_layer.to_out.weight", f"{op}/attn_layer/to_out/kernel", "lin_w")
        self.add(f"{tp}.attn_layer.to_out.bias", f"{op}/attn_layer/to_out/bias", "bias")
        self.mlp(f"{tp}.attn_mlp", f"{op}/attn_mlp")
        self.add(f"{tp}.gamma", f"{op}/gamma", "bias")
        if dim != out_dim:
            self.add(f"{tp}.out_proj.weight", f"{op}/out_proj/kernel", "lin_w")
            self.add(f"{tp}.out_proj.bias", f"{op}/out_proj/bias", "bias")

    def upsample(self, tp, op):
        self.add(f"{tp}.trans_conv.trans_conv.weight", f"{op}/trans_conv/trans_conv/kernel", "deconv_w")
        self.add(f"{tp}.trans_conv.trans_conv.bias", f"{op}/trans_conv/trans_conv/bias", "bias")

    def channel_att_bridge(self, tp, op, n_levels=7):
        self.add(f"{tp}.get_all_att.weight", f"{op}/get_all_att_kernel", "flat")
        self.add(f"{tp}.get_all_att.bias", f"{op}/get_all_att_bias", "bias")
        for i in range(1, n_levels + 1):
            self.add(f"{tp}.att{i}.weight", f"{op}/att{i}/kernel", "lin_w")
            self.add(f"{tp}.att{i}.bias", f"{op}/att{i}/bias", "bias")
        self.gate(f"{tp}.sigmoid1", f"{op}/sigmoid1")

    def encoder_to_decoder(self, tp, op, instance_norm=True):
        self.convlayer(f"{tp}.conv13pool", f"{op}/conv13pool")
        self.convlayer(f"{tp}.ffd13", f"{op}/ffd13")
        self.gate(f"{tp}.act_func13", f"{op}/act_func13")
        self.convlayer(f"{tp}.conv31pool", f"{op}/conv31pool")
        self.convlayer(f"{tp}.conv33pool", f"{op}/conv33pool")
        self.convlayer(f"{tp}.ffd33", f"{op}/ffd33")
        self.gate(f"{tp}.act_func33", f"{op}/act_func33")
        self.feedforward(f"{tp}.ffd", f"{op}/ffd")
        self.gate(f"{tp}.act", f"{op}/act")
        self.convffd(f"{tp}.mlp", f"{op}/mlp")
        if not instance_norm:
            self.groupnorm(tp, op)
        self.add(f"{tp}.gamma", f"{op}/gamma", "bias")
        self.scalars(tp, op, ("alpha1", "alpha2", "alpha3", "gama", "scale", "shift"))
        # reference ffd31/act_func31/conv33 are dead (:776-777) — ignored

    def out_proj_head(self, tp, op, instance_norm=True):
        self.wtconvlayer(f"{tp}.wtconv", f"{op}/wtconv", 3, bias=False, norm=True)
        if not instance_norm:
            self.groupnorm(f"{tp}.wtconv", f"{op}/wtconv")
        self.convlayer(f"{tp}.conv.0", f"{op}/conv_expand", bias=False)
        self.convlayer(f"{tp}.conv.1", f"{op}/conv_frames", bias=False)
        self.convlayer(f"{tp}.conv2", f"{op}/conv2", bias=False, swish_act=True)
        self.add(f"{tp}.gamma", f"{op}/gamma", "bias")
        self.scalars(tp, op, ("alpha1", "alpha2", "alpha", "beta"))


def adnm_name_map(
    embed_dim=(32, 64, 128, 256, 512, 1024),
    refine_dim=(32, 32, 32, 32),
    wt_levels=(3, 2, 1),
    headdim=4,
    refine_headdim=(4, 4, 4, 4),
    depth=(1, 1, 1),
    refine_depth=(1, 1, 1, 1),
    instance_norm=True,
    compute_dead_features=False,
):
    m = _Map()
    ed = list(embed_dim)
    # ----- encoder (reference: ADNMUNet.py:337-483) --------------------
    m.patch_embed("encoder.encoder1", "encoder/encoder1", wt_levels[0], instance_norm)
    m.wtlayer("encoder.encoder2", "encoder/encoder2", wt_levels[1], instance_norm)
    m.wtlayer("encoder.encoder3", "encoder/encoder3", wt_levels[2], instance_norm)
    m.attention("encoder.attn", "encoder/attn", ed[2], ed[2])
    m.block("encoder.encoder4", "encoder/encoder4", ed[2], ed[3], headdim, depth[0])
    m.block("encoder.encoder5", "encoder/encoder5", ed[3], ed[4], headdim, depth[1])
    m.block("encoder.encoder6", "encoder/encoder6", ed[4], ed[5], headdim, depth[2])
    m.attention("encoder.attn2", "encoder/attn2", ed[5], ed[5])
    # ----- decoder (reference: ADNMUNet.py:486-636) --------------------
    m.channel_att_bridge("decoder.fusion", "decoder/fusion")
    # the consumed features 0..2, and the dead 3..6 where the model has them
    for i in range(7 if compute_dead_features else 3):
        m.encoder_to_decoder(f"decoder.e2ds.{i}", f"decoder/e2d_{i}", instance_norm)
    m.block("decoder.decoder1", "decoder/decoder1", ed[5], ed[4], headdim, depth[2])
    m.upsample("decoder.up_sample1", "decoder/up_sample1")
    m.block("decoder.decoder2", "decoder/decoder2", ed[4] * 2, ed[3], headdim, depth[1])
    m.upsample("decoder.up_sample2", "decoder/up_sample2")
    m.block("decoder.decoder3", "decoder/decoder3", ed[3] * 2, ed[2], headdim, depth[0])
    m.attention("decoder.attn", "decoder/attn", ed[2], ed[2])
    m.upsample("decoder.up_sample3", "decoder/up_sample3")
    m.wtlayer("decoder.decoder4", "decoder/decoder4", wt_levels[2], instance_norm)
    m.upsample("decoder.up_sample4", "decoder/up_sample4")
    m.wtlayer("decoder.decoder5", "decoder/decoder5", wt_levels[1], instance_norm)
    m.upsample("decoder.up_sample5", "decoder/up_sample5")
    m.wtlayer("decoder.decoder6", "decoder/decoder6", wt_levels[0], instance_norm)
    m.convlayer("decoder.decoder6_s", "decoder/decoder6_s")
    # ----- refiner (reference: ADNMUNet.py:639-717) --------------------
    rd = list(refine_dim)
    for i in range(4):
        out_dim = rd[i + 1] if i < 3 else rd[-1]
        m.block(f"refiner.refiner{i + 1}", f"refiner/refiner{i + 1}", rd[i], out_dim,
                refine_headdim[i], refine_depth[i])
    m.out_proj_head("refiner.out_proj", "refiner/out_proj", instance_norm)
    return m.entries


def _apply(kind, t, extra, direction):
    """direction 'in' = torch -> ours, 'out' = ours -> torch."""
    if kind == "conv_w":
        return _conv_w(t) if direction == "in" else _conv_w_inv(t)
    if kind == "deconv_w":
        return _deconv_w(t) if direction == "in" else np.transpose(t, (2, 3, 0, 1))
    if kind == "lin_w":
        return _lin_w(t)
    if kind == "bias":
        return t
    if kind == "flat":
        return t.reshape(-1) if direction == "in" else t.reshape(1, 1, -1)
    if kind == "scalar":
        return t.reshape(()) if direction == "in" else t.reshape(())
    if kind == "vec4d":
        return t.reshape(-1) if direction == "in" else t.reshape(1, -1, 1, 1)
    if kind == "mixer_in_proj":
        d_model, headdim = extra
        d_inner = 2 * d_model
        gN = 2 * 16
        conv_dim = d_inner + 2 * gN
        xbc_perm, head_perm = adnssd_mixer_permutations(d_model, headdim)
        if direction == "in":
            k = _lin_w(t)  # (d_model, d_in_proj)
            z = k[:, :d_inner]
            xbc = k[:, d_inner : d_inner + conv_dim]
            dt = k[:, d_inner + conv_dim :]
            return np.concatenate([z, xbc[:, xbc_perm], dt[:, head_perm]], axis=1)
        k = t  # ours (d_model, d_in_proj)
        z = k[:, :d_inner]
        xbc_ref = np.empty_like(k[:, d_inner : d_inner + conv_dim])
        xbc_ref[:, xbc_perm] = k[:, d_inner : d_inner + conv_dim]
        dt_ref = np.empty_like(k[:, d_inner + conv_dim :])
        dt_ref[:, head_perm] = k[:, d_inner + conv_dim :]
        return np.transpose(np.concatenate([z, xbc_ref, dt_ref], axis=1), (1, 0))
    if kind == "mixer_head_vec":
        d_model, headdim = extra
        _, head_perm = adnssd_mixer_permutations(d_model, headdim)
        if direction == "in":
            return t[head_perm]
        out = np.empty_like(t)
        out[head_perm] = t
        return out
    raise ValueError(kind)


def convert_adnm_state_dict(state_dict, **cfg) -> dict:
    """The reference's state_dict (tensors or arrays; a DataParallel
    "module." prefix is accepted) -> the JAX-layout params tree. Raises
    KeyError on a missing key."""
    params: dict = {}
    for tname, (ours, kind, extra) in adnm_name_map(**cfg).items():
        key = tname if tname in state_dict else "module." + tname
        if key not in state_dict:
            raise KeyError(f"missing key in state_dict: {tname}")
        t = state_dict[key]
        t = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        _set(params, ours, _apply(kind, t, extra, "in"))
    return params



def export_adnm_state_dict(params: dict, **cfg) -> dict:
    """The JAX-layout params tree (``convert.to_jax_params`` of the port's
    model) -> a reference-layout state_dict of numpy arrays."""
    def get(tree, dotted):
        for p in dotted.split("/"):
            tree = tree[p]
        return np.asarray(tree)

    out = {}
    for tname, (ours, kind, extra) in adnm_name_map(**cfg).items():
        out[tname] = _apply(kind, get(params, ours), extra, "out")
    return out
