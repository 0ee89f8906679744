"""Torch state_dict importers for the baselines (counterpart of
adnm_tpu/train/torch_import.py): SmaAt-UNet, ConvLSTM, TrajGRU, LPTQPN,
TransUnet and SwinUnet.

The reference saves torch ``state_dict``s (train.py:174). Each converter
maps one, with the reference's module names (a DataParallel "module."
prefix is accepted), onto the JAX-layout ``params`` (and, for SmaAt-UNet
and TransUnet, ``batch_stats``) trees, which
``adnm_tpu_torch.convert.from_jax_params`` loads into the port's model;
``load_reference_state_dict`` does both, and
``export_reference_state_dict`` goes the other way for the models whose
maps hold only convolution, linear and plain entries (SmaAt-UNet,
TransUnet, SwinUnet). The name maps are the port's own copies of the JAX
package's.

  * conv weight (O, I, kh, kw) -> HWIO; ConvTranspose2d (I, O, kh, kw) ->
    (kh, kw, I, O); Linear (out, in) -> (in, out);
  * BatchNorm weight and bias -> params, running_mean / running_var ->
    batch_stats ``mean`` / ``var``;
  * ConvLSTM's peepholes (1, C, H, W) -> (H, W, C); the reference's are
    frozen zeros on CUDA and absent from its state_dict (ConvLSTM.py:26-28),
    so a missing one loads as zeros;
  * TrajGRU's forecaster cell without inputs has no i2h or i2f_conv1 in
    the port: the reference's unused ones are not read;
  * LPTQPN's attention temperature (heads, 1, 1) -> (heads,), Swish's beta
    -> a scalar;
  * TransUnet's and SwinUnet's LayerNorm weight -> ``scale``; SwinUnet's
    decoder blocks follow the encoder's depths (the reference's quirk).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from adnm_tpu_torch.convert import (
    flatten_tree,
    from_jax_params,
    to_jax_batch_stats,
    to_jax_params,
)
from adnm_tpu_torch.train.adnm_import import _conv_w, _conv_w_inv, _deconv_w, _lin_w, _set

NameMap = Dict[str, Tuple[str, str]]  # reference name -> (JAX path, kind)


def smaat_name_map() -> NameMap:
    """Reference: models/SmaAt_UNet.py:302-334."""
    m: NameMap = {}

    def double_conv(tp, op):
        for t_i, o_conv, o_bn in ((0, "conv1", "bn1"), (3, "conv2", "bn2")):
            for part in ("depthwise", "pointwise"):
                m[f"{tp}.{t_i}.{part}.weight"] = (f"{op}/{o_conv}/{part}/kernel", "conv_w")
                m[f"{tp}.{t_i}.{part}.bias"] = (f"{op}/{o_conv}/{part}/bias", "param")
            bn(f"{tp}.{t_i + 1}", f"{op}/{o_bn}")

    def bn(tp, op):
        m[f"{tp}.weight"] = (f"{op}/weight", "param")
        m[f"{tp}.bias"] = (f"{op}/bias", "param")
        m[f"{tp}.running_mean"] = (f"{op}/mean", "stat")
        m[f"{tp}.running_var"] = (f"{op}/var", "stat")

    def cbam(tp, op):
        for t_i, fc in ((1, "fc1"), (3, "fc2")):
            m[f"{tp}.channel_att.MLP.{t_i}.weight"] = (f"{op}/channel_att/{fc}/kernel", "lin_w")
            m[f"{tp}.channel_att.MLP.{t_i}.bias"] = (f"{op}/channel_att/{fc}/bias", "param")
        m[f"{tp}.spatial_att.conv.weight"] = (f"{op}/spatial_att/conv/kernel", "conv_w")
        bn(f"{tp}.spatial_att.bn", f"{op}/spatial_att/bn")

    double_conv("inc.double_conv", "inc")
    for i in range(1, 6):
        cbam(f"cbam{i}", f"cbam{i}")
    for i in range(1, 5):
        double_conv(f"down{i}.maxpool_conv.1.double_conv", f"down{i}")
        double_conv(f"up{i}.conv.double_conv", f"up{i}")
    m["outc.conv.weight"] = ("outc/kernel", "conv_w")
    m["outc.conv.bias"] = ("outc/bias", "param")
    return m


def _encoder_forecaster(m: NameMap) -> None:
    """The conv stages of the ConvLSTM and TrajGRU encoder-forecasters
    (reference: ConvLSTM.py:107-151,211-247; TrajGRU.py:348-398)."""
    for tp, op, kind in (("encoder.stage1.conv1_leaky_1", "e1_conv", "conv_w"),
                         ("encoder.stage2.conv2_leaky_1", "e2_conv", "conv_w"),
                         ("encoder.stage3.conv3_leaky_1", "e3_conv", "conv_w"),
                         ("forecaster.stage3.deconv1_leaky_1", "f_deconv1", "deconv_w"),
                         ("forecaster.stage2.deconv2_leaky_1", "f_deconv2", "deconv_w"),
                         ("forecaster.stage1.deconv3_leaky_1", "f_deconv3", "deconv_w"),
                         ("forecaster.stage1.conv3_leaky_2", "f_conv2", "conv_w"),
                         ("forecaster.stage1.conv3_3", "f_conv3", "conv_w")):
        m[f"{tp}.weight"] = (f"{op}/kernel", kind)
        m[f"{tp}.bias"] = (f"{op}/bias", "param")


RNNS = (("encoder.rnn1", "e_rnn1"), ("encoder.rnn2", "e_rnn2"), ("encoder.rnn3", "e_rnn3"),
        ("forecaster.rnn3", "f_rnn3"), ("forecaster.rnn2", "f_rnn2"),
        ("forecaster.rnn1", "f_rnn1"))


def convlstm_name_map() -> NameMap:
    """Reference: models/ConvLSTM.py."""
    m: NameMap = {}
    _encoder_forecaster(m)
    for tp, op in RNNS:
        m[f"{tp}._conv.weight"] = (f"{op}/cell/conv/kernel", "conv_w")
        m[f"{tp}._conv.bias"] = (f"{op}/cell/conv/bias", "param")
        for peep in ("Wci", "Wcf", "Wco"):
            m[f"{tp}.{peep}"] = (f"{op}/cell/{peep}", "peephole")
    return m


def trajgru_name_map() -> NameMap:
    """Reference: models/TrajGRU.py:110-145; the forecaster's rnn3 never
    takes inputs, so its i2h and i2f_conv1 are not mapped."""
    m: NameMap = {}
    _encoder_forecaster(m)
    for tp, op in RNNS:
        convs = [("h2f_conv1", "cell/h2f_conv1"), ("flows_conv", "cell/flows_conv"),
                 ("ret", "cell/ret")]
        if op != "f_rnn3":
            convs += [("i2h", "i2h"), ("i2f_conv1", "cell/i2f_conv1")]
        for t_name, o_name in convs:
            m[f"{tp}.{t_name}.weight"] = (f"{op}/{o_name}/kernel", "conv_w")
            m[f"{tp}.{t_name}.bias"] = (f"{op}/{o_name}/bias", "param")
    return m


def lptqpn_name_map(num_blocks=(4, 6, 6, 8), num_refinement_blocks: int = 2) -> NameMap:
    """Reference: models/LPTQPN.py:205-262. The reference's
    decoder_levels[0/1/2] are dec1/dec2/dec3 and upsamples[0/1/2] are
    up1/up2/up3."""
    m: NameMap = {}

    def block(tp, op):
        m[f"{tp}.norm1.body.weight"] = (f"{op}/norm1/weight", "param")
        m[f"{tp}.norm2.body.weight"] = (f"{op}/norm2/weight", "param")
        m[f"{tp}.attn.temperature"] = (f"{op}/attn/temperature", "flat")
        for conv in ("attn.qkv", "attn.qkv_dwconv", "attn.project_out", "ffn.project_in",
                     "ffn.dwconv", "ffn.project_out"):
            m[f"{tp}.{conv}.weight"] = (f"{op}/{conv.replace('.', '/')}/kernel", "conv_w")

    m["patch_embed.proj.weight"] = ("patch_embed/kernel", "conv_w")
    for lvl in range(3):
        for j in range(num_blocks[lvl]):
            block(f"encoder_levels.{lvl}.{j}", f"enc{lvl + 1}_{j}")
            block(f"decoder_levels.{lvl}.{j}", f"dec{lvl + 1}_{j}")
        m[f"downsamples.{lvl}.body.0.weight"] = (f"down{lvl + 1}/kernel", "conv_w")
        m[f"upsamples.{lvl}.body.0.weight"] = (f"up{lvl + 1}/kernel", "conv_w")
    for j in range(num_blocks[3]):
        block(f"central.{j}", f"central_{j}")
    for j in range(num_refinement_blocks):
        block(f"refinement.{j}", f"refine_{j}")
    for t_name, o_name in (("reduce_chan_level3", "reduce_chan_level3"),
                           ("reduce_chan_level2", "reduce_chan_level2"), ("output", "output"),
                           ("last.0", "last_conv")):
        m[f"{t_name}.weight"] = (f"{o_name}/kernel", "conv_w")
    m["last.0.bias"] = ("last_conv/bias", "param")
    m["last.1.beta"] = ("last_swish/beta", "scalar")
    return m


def transunet_name_map(block_units=(3, 4, 9), num_layers: int = 12) -> NameMap:
    """Reference: models/TransUnet.py (ResNetV2 :122-150, the ViT encoder
    :550-567, DecoderCup :649-676, SegmentationHead :641-646); the
    DecoderCup's Conv2dReLU is Sequential(conv, bn, relu)."""
    m: NameMap = {}
    e = "transformer.embeddings"
    m[f"{e}.hybrid_model.root.conv.weight"] = ("hybrid_model/root_conv/kernel", "conv_w")
    m[f"{e}.hybrid_model.root.gn.weight"] = ("hybrid_model/root_gn/weight", "param")
    m[f"{e}.hybrid_model.root.gn.bias"] = ("hybrid_model/root_gn/bias", "param")
    for bi, units in enumerate(block_units):
        for ui in range(units):
            tp = f"{e}.hybrid_model.body.block{bi + 1}.unit{ui + 1}"
            op = f"hybrid_model/block{bi + 1}_unit{ui + 1}"
            convs = ["conv1", "conv2", "conv3"] + (["downsample"] if ui == 0 else [])
            for conv in convs:
                m[f"{tp}.{conv}.weight"] = (f"{op}/{conv}/kernel", "conv_w")
            for gn in ["gn1", "gn2", "gn3"] + (["gn_proj"] if ui == 0 else []):
                m[f"{tp}.{gn}.weight"] = (f"{op}/{gn}/weight", "param")
                m[f"{tp}.{gn}.bias"] = (f"{op}/{gn}/bias", "param")
    m[f"{e}.patch_embeddings.weight"] = ("patch_embeddings/kernel", "conv_w")
    m[f"{e}.patch_embeddings.bias"] = ("patch_embeddings/bias", "param")
    m[f"{e}.position_embeddings"] = ("position_embeddings", "param")
    for i in range(num_layers):
        tp, op = f"transformer.encoder.layer.{i}", f"block_{i}"
        for nm in ("attention_norm", "ffn_norm"):
            m[f"{tp}.{nm}.weight"] = (f"{op}/{nm}/scale", "param")
            m[f"{tp}.{nm}.bias"] = (f"{op}/{nm}/bias", "param")
        for lin_t, lin_o in (("attn.query", "query"), ("attn.key", "key"),
                             ("attn.value", "value"), ("attn.out", "out"),
                             ("ffn.fc1", "fc1"), ("ffn.fc2", "fc2")):
            m[f"{tp}.{lin_t}.weight"] = (f"{op}/{lin_o}/kernel", "lin_w")
            m[f"{tp}.{lin_t}.bias"] = (f"{op}/{lin_o}/bias", "param")
    m["transformer.encoder.encoder_norm.weight"] = ("encoder_norm/scale", "param")
    m["transformer.encoder.encoder_norm.bias"] = ("encoder_norm/bias", "param")

    def conv2drelu(tp, op):
        m[f"{tp}.0.weight"] = (f"{op}/conv/kernel", "conv_w")
        m[f"{tp}.1.weight"] = (f"{op}/bn/weight", "param")
        m[f"{tp}.1.bias"] = (f"{op}/bn/bias", "param")
        m[f"{tp}.1.running_mean"] = (f"{op}/bn/mean", "stat")
        m[f"{tp}.1.running_var"] = (f"{op}/bn/var", "stat")

    conv2drelu("decoder.conv_more", "conv_more")
    for i in range(4):
        conv2drelu(f"decoder.blocks.{i}.conv1", f"dec{i}_conv1")
        conv2drelu(f"decoder.blocks.{i}.conv2", f"dec{i}_conv2")
    m["segmentation_head.0.weight"] = ("segmentation_head/kernel", "conv_w")
    m["segmentation_head.0.bias"] = ("segmentation_head/bias", "param")
    return m


def swinunet_name_map(depths=(2, 2, 2, 2)) -> NameMap:
    """Reference: models/SwinUnet.py (SwinTransformerSys :884-957 under the
    ``swin_unet`` attribute of the wrapper); the decoder's blocks follow
    the encoder's depths."""
    m: NameMap = {}
    nl = len(depths)
    s = "swin_unet"

    def norm(tp, op):
        m[f"{tp}.weight"] = (f"{op}/scale", "param")
        m[f"{tp}.bias"] = (f"{op}/bias", "param")

    def linear(tp, op, bias=True):
        m[f"{tp}.weight"] = (f"{op}/kernel", "lin_w")
        if bias:
            m[f"{tp}.bias"] = (f"{op}/bias", "param")

    def block(tp, op):
        norm(f"{tp}.norm1", f"{op}/norm1")
        m[f"{tp}.attn.relative_position_bias_table"] = (
            f"{op}/attn/relative_position_bias_table", "param")
        linear(f"{tp}.attn.qkv", f"{op}/attn/qkv")
        linear(f"{tp}.attn.proj", f"{op}/attn/proj")
        norm(f"{tp}.norm2", f"{op}/norm2")
        linear(f"{tp}.mlp.fc1", f"{op}/fc1")
        linear(f"{tp}.mlp.fc2", f"{op}/fc2")

    m[f"{s}.patch_embed.proj.weight"] = (f"{s}/patch_embed_proj/kernel", "conv_w")
    m[f"{s}.patch_embed.proj.bias"] = (f"{s}/patch_embed_proj/bias", "param")
    norm(f"{s}.patch_embed.norm", f"{s}/patch_embed_norm")
    for li in range(nl):
        for i in range(depths[li]):
            block(f"{s}.layers.{li}.blocks.{i}", f"{s}/layer{li}_blk{i}")
        if li < nl - 1:
            linear(f"{s}.layers.{li}.downsample.reduction", f"{s}/merge{li}/reduction", False)
            norm(f"{s}.layers.{li}.downsample.norm", f"{s}/merge{li}/norm")
    linear(f"{s}.layers_up.0.expand", f"{s}/up0/expand", False)
    norm(f"{s}.layers_up.0.norm", f"{s}/up0/norm")
    for li in range(1, nl):
        for i in range(depths[nl - 1 - li]):
            block(f"{s}.layers_up.{li}.blocks.{i}", f"{s}/layer_up{li}_blk{i}")
        linear(f"{s}.concat_back_dim.{li}", f"{s}/concat_back_dim{li}")
        if li < nl - 1:
            linear(f"{s}.layers_up.{li}.upsample.expand", f"{s}/up{li}/expand", False)
            norm(f"{s}.layers_up.{li}.upsample.norm", f"{s}/up{li}/norm")
    norm(f"{s}.norm", f"{s}/norm")
    norm(f"{s}.norm_up", f"{s}/norm_up")
    linear(f"{s}.up.expand", f"{s}/up_final/expand", False)
    norm(f"{s}.up.norm", f"{s}/up_final/norm")
    m[f"{s}.output.weight"] = (f"{s}/output/kernel", "conv_w")
    return m


_IN = {"conv_w": _conv_w, "deconv_w": _deconv_w, "lin_w": _lin_w, "param": lambda t: t,
       "stat": lambda t: t, "peephole": lambda t: t[0].transpose(1, 2, 0),
       "flat": lambda t: t.reshape(-1), "scalar": lambda t: t.reshape(())}


def convert_state_dict(state_dict: Mapping, name_map: NameMap,
                       optional: Tuple[str, ...] = ()) -> Tuple[dict, dict]:
    """A reference state_dict (tensors or arrays) -> the JAX-layout
    (params, batch_stats) trees through ``name_map``. Raises KeyError on a
    missing key, except those of the kinds in ``optional``, which are
    left out."""
    params: dict = {}
    stats: dict = {}
    for t_name, (path, kind) in name_map.items():
        key = t_name if t_name in state_dict else "module." + t_name
        if key not in state_dict:
            if kind in optional:
                continue
            raise KeyError(f"missing key in state_dict: {t_name}")
        t = state_dict[key]
        t = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        _set(stats if kind == "stat" else params, path, _IN[kind](t))
    return params, stats


_OUT = {"conv_w": _conv_w_inv, "deconv_w": lambda k: np.transpose(k, (2, 3, 0, 1)),
        "lin_w": _lin_w, "param": lambda t: t, "stat": lambda t: t}


def export_state_dict(model: nn.Module, name_map: NameMap) -> Dict[str, np.ndarray]:
    """The reference-layout state_dict (numpy arrays) of ``model`` through
    ``name_map``, for maps whose kinds ``_OUT`` inverts."""
    flat = {**flatten_tree(to_jax_params(model)), **flatten_tree(to_jax_batch_stats(model))}
    return {t_name: _OUT[kind](flat[path]) for t_name, (path, kind) in name_map.items()}


def _zero_peepholes(params: dict, model: nn.Module) -> None:
    """Zeros, in the JAX layout, for each peephole the tree lacks."""
    for name, p in model.named_parameters():
        leaf = name.rpartition(".")[2]
        if leaf in ("Wci", "Wcf", "Wco"):
            node = params
            for part in name.split(".")[:-1]:
                node = node.setdefault(part, {})
            node.setdefault(leaf, np.zeros(p.shape[1:] + p.shape[:1], np.float32))


def load_reference_state_dict(model_name: str, model: nn.Module, state_dict: Mapping,
                              num_blocks: Optional[Tuple[int, ...]] = None,
                              num_refinement_blocks: Optional[int] = None) -> nn.Module:
    """Load a reference-format state_dict of ``model_name`` (SmaATUnet,
    ConvLSTM, TrajGRU, LPTQPN, TransUnet or SwinUnet) into the port's
    ``model`` (parameters and, for SmaATUnet and TransUnet, running
    statistics). ``num_blocks`` and ``num_refinement_blocks`` describe an
    LPTQPN built with other depths than the reference's; TransUnet's and
    SwinUnet's depths are read from ``model``."""
    if model_name == "SmaATUnet":
        params, stats = convert_state_dict(state_dict, smaat_name_map())
        return from_jax_params(model, params, stats)
    if model_name == "ConvLSTM":
        params, _ = convert_state_dict(state_dict, convlstm_name_map(), optional=("peephole",))
        _zero_peepholes(params, model)
        return from_jax_params(model, params)
    if model_name == "TrajGRU":
        return from_jax_params(model, convert_state_dict(state_dict, trajgru_name_map())[0])
    if model_name == "LPTQPN":
        name_map = lptqpn_name_map(num_blocks or (4, 6, 6, 8),
                                   2 if num_refinement_blocks is None else num_refinement_blocks)
        return from_jax_params(model, convert_state_dict(state_dict, name_map)[0])
    if model_name in ("TransUnet", "SwinUnet"):
        params, stats = convert_state_dict(state_dict, reference_name_map(model_name, model))
        return from_jax_params(model, params, stats or None)
    raise ValueError(f"no reference importer for {model_name!r} (ADNMUnet: "
                     f"adnm_tpu_torch.train.adnm_import)")


def reference_name_map(model_name: str, model: nn.Module) -> NameMap:
    """The name map of SmaATUnet, TransUnet or SwinUnet, with the depths of
    ``model``."""
    if model_name == "SmaATUnet":
        return smaat_name_map()
    if model_name == "TransUnet":
        return transunet_name_map(model.hybrid_model.block_units, model.num_layers)
    if model_name == "SwinUnet":
        return swinunet_name_map(model.swin_unet.depths)
    raise ValueError(f"no reference export for {model_name!r}")


def export_reference_state_dict(model_name: str, model: nn.Module) -> Dict[str, np.ndarray]:
    """``model``'s weights (and running statistics) as a reference-format
    state_dict of numpy arrays: SmaATUnet, TransUnet or SwinUnet."""
    return export_state_dict(model, reference_name_map(model_name, model))
