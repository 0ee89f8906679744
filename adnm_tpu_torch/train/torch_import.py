"""Torch state_dict importers for the baselines (counterpart of
adnm_tpu/train/torch_import.py): SmaAt-UNet, ConvLSTM, TrajGRU and LPTQPN.

The reference saves torch ``state_dict``s (train.py:174). Each converter
maps one, with the reference's module names (a DataParallel "module."
prefix is accepted), onto the JAX-layout ``params`` (and, for SmaAt-UNet,
``batch_stats``) trees, which ``adnm_tpu_torch.convert.from_jax_params``
loads into the port's model; ``load_reference_state_dict`` does both.
The name maps are the port's own copies of the JAX package's.

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
    -> a scalar.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from adnm_tpu_torch.convert import from_jax_params
from adnm_tpu_torch.train.adnm_import import _conv_w, _deconv_w, _lin_w, _set

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
    ConvLSTM, TrajGRU or LPTQPN) into the port's ``model`` (parameters
    and, for SmaATUnet, running statistics). ``num_blocks`` and
    ``num_refinement_blocks`` describe an LPTQPN built with other depths
    than the reference's."""
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
    raise ValueError(f"no reference importer for {model_name!r} (ADNMUnet: "
                     f"adnm_tpu_torch.train.adnm_import)")
