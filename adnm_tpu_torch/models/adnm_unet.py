"""ADNM-UNet, the flagship nowcasting model, on NCHW tensors
(counterpart of adnm_tpu/models/adnm_unet.py).

Encoder (PatchEmbed -> WTLayer x2 -> attention -> ADN-SSD Blocks x3 with
max-pool downsampling, 7 skips), Decoder (Blocks x3 + attention + WTLayer
x3 with skip concats, a ChannelAttBridge and the EncoderToDecoder
features) and Refiner (4 Blocks at full resolution + the OutProj head
with the last-input-frame residual). Contract:
(B, T_in, 1, H, W) -> (B, T_out, 1, H, W).

The ADN-SSD and VSSD mixers (``mixer_type``), each with the duality or
the bimamba chunked scan (``linear_attn_duality``); softmax attention or
MLA (``attn_type``) at the three AttentionBlock sites; the PatchEmbed or
the one-conv ``SimplePatchEmbed`` (``simple_patch``). The decoder computes
only the features it consumes (the JAX default), or also the reference's
four dead ones (``compute_dead_features``: the same prediction, a larger
parameter tree). Every configuration trains: the chunked
scan (K2) has its backward kernel. ``refiner_remat`` recomputes each
refiner Block's forward in the backward, as the JAX model does;
``apply_reference_init`` is the reference's init scheme.

The model computes in its input's dtype (the JAX package's ``--bf16``
feeds bf16 frames): parameters stay fp32, every layer casts its weights
and gates where the JAX model does, and the output comes in the dtype the
layers give it (bf16 for the ADN-SSD mixer's configurations; fp32 from the
first Block on for the VSSD duality, whose mixers return fp32 as in JAX).
The VSSD bimamba configuration runs in fp32 only
(``mixers.vssd.check_compute_dtype``).

On a mesh's 'model' axis the mixers and the FeedForward of
every Block, AttentionBlock and refiner Block split their heads and hidden
channels over the ranks; they read the mesh that the caller makes active
around the forward (``parallel.tensor.use_mesh``), so no module passes it
on. Everything else, MLA included, runs whole on every rank, as in JAX.

On its 'seq' axis each rank holds a contiguous band of the
rows of every frame, where JAX's ``maybe_shard`` annotations split H
(adnm_tpu/models/adnm_unet.py:278-294,381-449): ``encoder1`` to
``encoder3`` with ``down_sample1`` to ``down_sample3`` and the skips they
make (256^2, 128^2 and 64^2 on the Shanghai shape), and ``decoder4`` to
``decoder6_s`` with ``up_sample4`` and ``up_sample5``, the refiner's four
Blocks and its ``OutProj`` (its L = H W tokens a segment per rank). The
bands are gathered once after ``down_sample3``, and every rank runs the
middle whole (the attention blocks, ``encoder4`` to ``decoder3``, MLA,
the ``EncoderToDecoder`` features, as JAX pins them replicated) up to
``up_sample3``, whose output each rank cuts to its band again. The
prediction is gathered over 'seq' before the forward returns. The split
stages run inside ``parallel.tensor.split_rows``, where the layers take
their halos and frame statistics (``core/layers.py``), the duality sums
K^T V over the ranks and K2 carries its state from rank to rank
(``ops/ssd.py``). A frame is split only where every split stage's band
fits it (``band_rule``); otherwise every 'seq' rank runs the whole
forward, the same result. Both axes train (``Trainer(ddp=True,
mesh=...)``): every gather, sum and halo, and K2's carried scan, has its
exact adjoint as its backward, and the refiner's remat recomputes each
Block on its band with the forward's collectives, so the launch and
traffic counters count the recomputed ones too.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from adnm_tpu_torch.convert import jax_keys

from adnm_tpu_torch.core.blocks import (
    ChannelAttBridge,
    DownSample,
    EncoderToDecoder,
    OutProj,
    PatchEmbed,
    SimplePatchEmbed,
    UpSample,
    WTLayer,
)
from adnm_tpu_torch.core.layers import (
    BiasFreeLayerNorm,
    ConvLayer,
    FeedForward,
    Linear,
    Mlp,
    RMSNorm,
    channel_linear,
    channel_scale,
    gate_cast,
    scalar_param,
)
from adnm_tpu_torch.mixers import vssd
from adnm_tpu_torch.mixers.attention import MLA, StandardAttention, generate_mla_config
from adnm_tpu_torch.mixers.ssd_mixer import ADNSSDMixer
from adnm_tpu_torch.mixers.vssd import VSSDMixer
from adnm_tpu_torch.parallel.tensor import (band_rows, gather_seq, in_mesh_state, seq_band,
                                            split_rows)


def make_mixer(mixer_type: str, dim: int, headdim: int, linear_attn_duality: bool) -> nn.Module:
    if mixer_type == "adnssd":
        return ADNSSDMixer(dim, headdim=headdim, linear_attn_duality=linear_attn_duality)
    if mixer_type == "vssd":
        return VSSDMixer(dim, headdim=headdim, linear_attn_duality=linear_attn_duality)
    raise ValueError(f"mixer_type must be 'adnssd' or 'vssd', got {mixer_type!r}")


def schedule_headdim(d_model: int) -> int:
    """Reference: models/ADNMUNet.py:263-273 (create_block)."""
    if d_model <= 32:
        return 4
    if d_model <= 256:
        return 8
    if d_model <= 512:
        return 16
    if d_model <= 768:
        return 24
    return 32


class Block(nn.Module):
    """Mamba residual block: ``num_layers`` of scale/shift-modulated RMSNorm
    (kernel K1 over the channel axis) -> mixer -> beta residual -> RMSNorm
    -> FeedForward -> beta residual; gamma scale; optional out projection.
    As in the reference, the second residual reads beta1/beta2 again; the
    JAX tree's beta3/beta4 are never read and the port holds no copy."""

    def __init__(self, dim: int, out_dim: int, headdim: int, num_layers: int = 1,
                 norm_epsilon: float = 1e-5, linear_attn_duality: bool = True,
                 mixer_type: str = "adnssd"):
        super().__init__()
        self.num_layers = num_layers
        for name in ("alpha1", "alpha2", "alpha3", "alpha4"):
            setattr(self, name, scalar_param(1.0))
        self.beta1 = nn.Parameter(torch.ones(num_layers))
        self.beta2 = nn.Parameter(torch.ones(num_layers))
        for i in range(num_layers):
            setattr(self, f"scale1_{i}", scalar_param(1.0))
            setattr(self, f"shift1_{i}", scalar_param(0.0))
            setattr(self, f"scale2_{i}", scalar_param(1.0))
            setattr(self, f"shift2_{i}", scalar_param(0.0))
            self.add_module(f"norm1_{i}", RMSNorm(dim, norm_epsilon, axis=1))
            self.add_module(f"mixer_{i}", make_mixer(mixer_type, dim, headdim,
                                                     linear_attn_duality))
            self.add_module(f"norm2_{i}", RMSNorm(dim, norm_epsilon, axis=1))
            self.add_module(f"ffn_{i}", FeedForward(dim, expansion=2))
        self.gamma = nn.Parameter(torch.ones(dim))
        self.out_proj = Linear(dim, out_dim) if dim != out_dim else None

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                features: Optional[torch.Tensor] = None) -> torch.Tensor:
        # the gates in the input's dtype, the layers' in x's at their start
        alpha1, alpha2, alpha3, alpha4, beta1, beta2 = gate_cast(
            x, self.alpha1, self.alpha2, self.alpha3, self.alpha4, self.beta1, self.beta2)
        if residual is not None:
            x = torch.cat([alpha1 * x, alpha2 * residual.to(x.dtype)], dim=1)
            if features is not None:
                f = features.to(x.dtype)
                x = x + torch.cat([alpha3 * f, alpha4 * f], dim=1)
        elif features is not None:
            x = x + alpha3 * features.to(x.dtype)
        for i in range(self.num_layers):
            scale1, shift1, scale2, shift2 = gate_cast(
                x, *(getattr(self, f"{name}_{i}") for name in
                     ("scale1", "shift1", "scale2", "shift2")))
            norm1, mixer, norm2, ffn = (getattr(self, f"{name}_{i}") for name in
                                        ("norm1", "mixer", "norm2", "ffn"))
            b1, b2 = beta1[i], beta2[i]
            x = b1 * x + b2 * mixer(scale1 * norm1(x) + shift1)
            x = b1 * x + b2 * ffn(scale2 * norm2(x) + shift2)
        x = channel_scale(x, self.gamma)
        if self.out_proj is not None:
            x = channel_linear(self.out_proj, x)
        return x


class AttentionBlock(nn.Module):
    """Attention with the Block skeleton: bias-free LayerNorm -> attention
    (softmax ``StandardAttention``, or ``MLA`` over the H*W tokens for
    ``attn_type="mla"``) -> beta residual -> LayerNorm -> Mlp -> beta
    residual, gamma, optional out projection. No caller passes the JAX
    module's residual or features, so they are not ported; their gates
    alpha1..alpha4 are carried and never read."""

    def __init__(self, dim: int, out_dim: Optional[int] = None, headdim: int = 4,
                 attn_type: str = "standard"):
        super().__init__()
        out_dim = out_dim or dim
        for name in ("alpha1", "alpha2", "alpha3", "alpha4",
                     "beta1", "beta2", "beta3", "beta4", "attn_scale1", "attn_scale2"):
            setattr(self, name, scalar_param(1.0))
        self.attn_shift1 = scalar_param(0.0)
        self.attn_shift2 = scalar_param(0.0)
        self.attn_norm1 = BiasFreeLayerNorm(dim)
        if attn_type == "mla":
            self.attn_layer = MLA(**generate_mla_config(dim, strict=False))
        elif attn_type == "standard":
            self.attn_layer = StandardAttention(dim, heads=dim // headdim, dim_head=headdim)
        else:
            raise ValueError(f"attn_type must be standard|mla, got {attn_type!r}")
        self.attn_norm2 = BiasFreeLayerNorm(dim)
        self.attn_mlp = Mlp(dim)
        self.gamma = nn.Parameter(torch.ones(dim))
        self.out_proj = Linear(dim, out_dim) if dim != out_dim else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta1, beta2, beta3, beta4, scale1, shift1, scale2, shift2 = gate_cast(
            x, self.beta1, self.beta2, self.beta3, self.beta4, self.attn_scale1,
            self.attn_shift1, self.attn_scale2, self.attn_shift2)
        x_norm = scale1 * self.attn_norm1(x) + shift1
        x = beta1 * x + beta2 * self._attend(x_norm)
        x_norm = scale2 * self.attn_norm2(x) + shift2
        x = beta3 * x + beta4 * self.attn_mlp(x_norm)
        x = channel_scale(x, self.gamma)
        if self.out_proj is not None:
            x = channel_linear(self.out_proj, x)
        return x

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        if not isinstance(self.attn_layer, MLA):
            return self.attn_layer(x)
        b, d, h, w = x.shape
        out = self.attn_layer(x.flatten(2).transpose(1, 2))  # (B, H*W, d) tokens
        return out.transpose(1, 2).reshape(b, d, h, w)


class Encoder(nn.Module):
    def __init__(self, embed_dim: Sequence[int], depth: Sequence[int], headdim: int,
                 in_channels: int, kernel: Sequence[int], ratio: Sequence[int],
                 wt_levels: Sequence[int], norm_epsilon: float = 1e-5,
                 instance_norm: bool = True, simple_patch: bool = False,
                 linear_attn_duality: bool = True, mixer_type: str = "adnssd",
                 attn_type: str = "standard"):
        super().__init__()
        ed = embed_dim
        mix = dict(linear_attn_duality=linear_attn_duality, mixer_type=mixer_type)
        if simple_patch:
            self.encoder1 = SimplePatchEmbed(in_channels, ed[0], kernel[0], instance_norm)
        else:
            self.encoder1 = PatchEmbed(in_channels, ed[0], kernel[0], wt_levels[0],
                                       instance_norm=instance_norm)
        self.down_sample1 = DownSample(ratio[0])
        self.encoder2 = WTLayer(ed[0], ed[1], kernel[1], wt_levels[1], instance_norm=instance_norm)
        self.down_sample2 = DownSample(ratio[1])
        self.encoder3 = WTLayer(ed[1], ed[2], kernel[2], wt_levels[2], instance_norm=instance_norm)
        self.down_sample3 = DownSample(ratio[2])
        self.attn = AttentionBlock(ed[2], headdim=headdim, attn_type=attn_type)
        self.encoder4 = Block(ed[2], ed[3], headdim, depth[0], norm_epsilon, **mix)
        self.down_sample4 = DownSample(ratio[3])
        self.encoder5 = Block(ed[3], ed[4], headdim, depth[1], norm_epsilon, **mix)
        self.down_sample5 = DownSample(ratio[4])
        self.encoder6 = Block(ed[4], ed[5], headdim, depth[2], norm_epsilon, **mix)
        self.attn2 = AttentionBlock(ed[5], headdim=headdim, attn_type=attn_type)

    def forward(self, x: torch.Tensor, band: Optional[slice] = None):
        """``band``: this rank's rows of the frames over 'seq' (``seq_band``),
        which the first three stages and their skips hold; None, the
        frames whole."""
        skips = []
        with split_rows(band):
            if band is not None:
                x = x[:, :, band]
            x, res = self.encoder1(x)
            skips.append(x)
            x = self.encoder2(self.down_sample1(x))
            skips.append(x)
            x = self.encoder3(self.down_sample2(x))
            skips.append(x)
            x = self.down_sample3(x)
        if band is not None:
            x = gather_seq(x)
        x = self.attn(x)
        skips.append(x)
        x = self.encoder4(x)
        skips.append(x)
        x = self.encoder5(self.down_sample4(x))
        skips.append(x)
        x = self.encoder6(self.down_sample5(x))
        skips.append(x)
        return self.attn2(x), skips, res


class Decoder(nn.Module):
    def __init__(self, embed_dim: Sequence[int], depth: Sequence[int], headdim: int,
                 refine_dim: Sequence[int], kernel: Sequence[int], ratio: Sequence[int],
                 wt_levels: Sequence[int], norm_epsilon: float = 1e-5,
                 instance_norm: bool = True, compute_dead_features: bool = False,
                 linear_attn_duality: bool = True, mixer_type: str = "adnssd",
                 attn_type: str = "standard"):
        super().__init__()
        ed = list(embed_dim)
        mix = dict(linear_attn_duality=linear_attn_duality, mixer_type=mixer_type)
        c_list = ed[:2] + [ed[2], ed[2]] + ed[3:]  # level 2 listed twice
        self.fusion = ChannelAttBridge(c_list)
        # e2d_i works on skip 6 - i; only features 0..2 are consumed. With
        # compute_dead_features, e2d_3..e2d_6 are built and run as in the
        # reference: feature 3 goes nowhere, and WTLayer discards 4..6
        # beside its residual (adnm_tpu/core/blocks.py:130-134).
        self.n_features = 7 if compute_dead_features else 3
        for i in range(self.n_features):
            self.add_module(f"e2d_{i}", EncoderToDecoder(c_list[6 - i], instance_norm))
        self.decoder1 = Block(ed[5], ed[4], headdim, depth[2], norm_epsilon, **mix)
        self.up_sample1 = UpSample(ed[4], ed[4], ratio=ratio[4])
        self.decoder2 = Block(ed[4] * 2, ed[3], headdim, depth[1], norm_epsilon, **mix)
        self.up_sample2 = UpSample(ed[3], ed[3], ratio=ratio[3])
        self.decoder3 = Block(ed[3] * 2, ed[2], headdim, depth[0], norm_epsilon, **mix)
        self.attn = AttentionBlock(ed[2], ed[2], headdim=headdim, attn_type=attn_type)
        self.up_sample3 = UpSample(ed[2], ed[2], ratio=ratio[2])
        self.decoder4 = WTLayer(ed[2] * 2, ed[1], kernel[2], wt_levels[2], if_res=True,
                                instance_norm=instance_norm)
        self.up_sample4 = UpSample(ed[1], ed[1], ratio=ratio[1])
        self.decoder5 = WTLayer(ed[1] * 2, ed[0], kernel[1], wt_levels[1], if_res=True,
                                instance_norm=instance_norm)
        self.up_sample5 = UpSample(ed[0], ed[0], ratio=ratio[0])
        self.decoder6 = WTLayer(ed[0] * 2, ed[0], kernel[0], wt_levels[0], if_res=True,
                                instance_norm=instance_norm)
        self.decoder6_s = ConvLayer(ed[0], refine_dim[0], 1, 1, 0)

    def forward(self, x: torch.Tensor, skips, band: Optional[slice] = None) -> torch.Tensor:
        """``band``: the encoder's; skips 0-2 are then bands, and so is the
        output."""
        split = [band is not None] * 3 + [False] * 4  # which skips are bands
        fusion = self.fusion(skips, split)
        feats = [getattr(self, f"e2d_{i}")(gather_seq(skips[6 - i]) if split[6 - i]
                                           else skips[6 - i], fusion[6 - i])
                 for i in range(self.n_features)]
        x = self.up_sample1(self.decoder1(x, features=feats[0]))
        x = self.up_sample2(self.decoder2(x, residual=skips[5], features=feats[1]))
        x = self.decoder3(x, residual=skips[4], features=feats[2])
        x = self.up_sample3(self.attn(x))
        with split_rows(band):
            if band is not None:
                x = x[:, :, band_rows(x.shape[2])]
            x = self.up_sample4(self.decoder4(x, residual=skips[2]))
            x = self.up_sample5(self.decoder5(x, residual=skips[1]))
            x = self.decoder6(x, residual=skips[0])
            return self.decoder6_s(x)


class Refiner(nn.Module):
    """Four Blocks at full resolution, then the OutProj head. With
    ``remat``, while gradients are enabled, each Block runs under
    ``torch.utils.checkpoint``: the backward recomputes its forward instead
    of keeping its activations (the 65,536-token mixers), as the JAX model's
    ``nn.remat`` does: K1 and, in the bimamba configurations, K2 run again
    there."""

    def __init__(self, refine_dim: Sequence[int], refine_depth: Sequence[int],
                 refine_headdim: Sequence[int], out_channels: int, out_expand: int = 2,
                 norm_epsilon: float = 1e-5, instance_norm: bool = True,
                 linear_attn_duality: bool = True, mixer_type: str = "adnssd",
                 remat: bool = True):
        super().__init__()
        self.remat = remat
        rd = refine_dim
        for i in range(4):
            self.add_module(f"refiner{i + 1}", Block(
                rd[i], rd[i + 1] if i < 3 else rd[-1], refine_headdim[i], refine_depth[i],
                norm_epsilon, linear_attn_duality, mixer_type))
        self.out_proj = OutProj(out_channels, rd[-1], out_expand, instance_norm)

    def forward(self, x: torch.Tensor, res: torch.Tensor,
                band: Optional[slice] = None) -> torch.Tensor:
        """``band``: ``x`` and ``res`` are this rank's rows of the frame over
        'seq', and so is the output."""
        with split_rows(band):
            for i in range(4):
                block = getattr(self, f"refiner{i + 1}")
                if self.remat and torch.is_grad_enabled():
                    # preserve_rng_state=False: a Block draws nothing at random, and
                    # stashing the default generators' states would read the card's
                    # on the host, which a CUDA graph capture refuses. The recompute
                    # in the backward runs on the band again, with the forward's
                    # collectives in the same order on every rank.
                    x = checkpoint(in_mesh_state(block), x, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = block(x)
            return self.out_proj(x, res)


class ADNMUNet(nn.Module):
    """(B, T_in, 1, H, W) -> (B, T_out, 1, H, W)."""

    def __init__(self, embed_dim: Sequence[int] = (32, 64, 128, 256, 512, 1024),
                 depth: Sequence[int] = (1, 1, 1), refine_depth: Sequence[int] = (1, 1, 1, 1),
                 refine_dim: Sequence[int] = (32, 32, 32, 32),
                 refine_headdim: Sequence[int] = (4, 4, 4, 4), headdim: int = 4,
                 channels: int = 5, out_channels: int = 20, kernel: Sequence[int] = (5, 5, 5),
                 ratio: Sequence[int] = (2, 2, 2, 2, 2, 2), wt_levels: Sequence[int] = (3, 2, 1),
                 out_expand: int = 2, norm_epsilon: float = 1e-6, instance_norm: bool = True,
                 simple_patch: bool = False, compute_dead_features: bool = False,
                 linear_attn_duality: bool = True, mixer_type: str = "adnssd",
                 attn_type: str = "standard", refiner_remat: bool = True):
        super().__init__()
        self.mixer_type, self.linear_attn_duality = mixer_type, linear_attn_duality
        mix = dict(linear_attn_duality=linear_attn_duality, mixer_type=mixer_type)
        self.encoder = Encoder(embed_dim, depth, headdim, channels, kernel, ratio, wt_levels,
                               norm_epsilon, instance_norm, simple_patch, **mix,
                               attn_type=attn_type)
        self.decoder = Decoder(embed_dim, depth, headdim, refine_dim, kernel, ratio, wt_levels,
                               norm_epsilon, instance_norm, compute_dead_features, **mix,
                               attn_type=attn_type)
        self.refiner = Refiner(refine_dim, refine_depth, refine_headdim, out_channels,
                               out_expand, norm_epsilon, instance_norm, **mix,
                               remat=refiner_remat)
        head = self.refiner.out_proj.wtconv.conv
        self.band_rule = band_rule(kernel, wt_levels, simple_patch,
                                   (head.wt_levels, head.base_conv.kernel_size[0]))

    def check_compute_dtype(self, dtype: torch.dtype) -> None:
        """Raise where this configuration cannot compute in ``dtype``: the
        VSSD bimamba one outside fp32 (``mixers.vssd.check_compute_dtype``)."""
        if self.mixer_type == "vssd":
            vssd.check_compute_dtype(self.linear_attn_duality, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.check_compute_dtype(x.dtype)
        # this rank's band of the frames over the active mesh's 'seq' axis
        band = None if self.band_rule is None else seq_band(x.shape[-2], *self.band_rule)
        x, skips, res = self.encoder(x[:, :, 0], band)  # frames as NCHW channels
        x = self.decoder(x, skips, band)
        x = self.refiner(x, res, band)
        if band is not None:
            x = gather_seq(x)
        return x[:, :, None]


def band_rule(kernel: Sequence[int], wt_levels: Sequence[int], simple_patch: bool,
              head: tuple) -> Optional[tuple]:
    """(multiple, min_rows) of ``seq_band``: what a band of the frame's rows
    must be for every split stage to run on it. Each stage at 1 / 2^shift
    of the frame takes ``levels`` Haar levels (the band's rows halve at
    each, so they must divide by 2^(shift + levels)) and a kernel of ``k``
    taps at the last of them (whose halo, k // 2 rows, must fit a band
    there); the three 2x2 pools need a multiple of 8. ``head`` is the
    OutProj WTConv's (Haar levels, taps), read from the built module. None
    (never split) where the one-conv patch embed's even kernel changes the
    frame's size."""
    if simple_patch and kernel[0] % 2 == 0:
        return None
    # (shift, Haar levels, taps): decoder6 (and encoder1's WTConvs, or its
    # one conv), encoder2 / decoder5, encoder3 / decoder4, the OutProj's
    # WTConv
    stages = [(0, wt_levels[0], kernel[0]), (1, wt_levels[1], kernel[1]),
              (2, wt_levels[2], kernel[2]), (0, *head)]
    multiple = max(8, *(2 ** (sh + lv) for sh, lv, _ in stages))
    min_rows = max(2 ** (sh + lv) * max(1, k // 2) for sh, lv, k in stages)
    return multiple, min_rows


def create_adnm_unet(input_frames: int, output_frames: int, frame_interval: int,
                     img_size: int = 256, **kwargs) -> ADNMUNet:
    """Reference: models/ADNMUNet.py:906-940 (create_ADNMUNet). The model
    takes any frame size that five halvings divide, which ``img_size``
    must be (the weights do not depend on it); ``kwargs`` go to
    ``ADNMUNet`` (``linear_attn_duality``, ``mixer_type``, ``attn_type``,
    ``simple_patch``, ``compute_dead_features``, ``refiner_remat``)."""
    if img_size % 32:
        raise ValueError(f"img_size {img_size}: five halvings must divide the frame size")
    refine_dim = (32, 32, 32, 32) if output_frames > 5 else (32, 32, 16, 16)
    if frame_interval < 120 / input_frames:
        instance_norm, kernel = True, (5, 5, 5)
    else:
        instance_norm, kernel = False, (5, 3, 3)
    return ADNMUNet(
        embed_dim=(32, 64, 128, 256, 512, 1024), depth=(1, 1, 1), refine_depth=(1, 1, 1, 1),
        refine_headdim=(4, 4, 4, 4), refine_dim=refine_dim, headdim=4,
        channels=input_frames, out_channels=output_frames, kernel=kernel,
        ratio=(2, 2, 2, 2, 2, 2), wt_levels=(3, 2, 1), out_expand=2, norm_epsilon=1e-6,
        instance_norm=instance_norm, **kwargs,
    )


def _trunc_normal_(t: torch.Tensor, gen: torch.Generator, std: float, bound: float = 2.0):
    """N(0, 1) truncated to [-bound, bound], times ``std`` (as
    ``jax.random.truncated_normal``): the inverse CDF of a uniform draw."""
    lo = (1.0 + math.erf(-bound / math.sqrt(2.0))) / 2.0
    t.uniform_(2.0 * lo - 1.0, 1.0 - 2.0 * lo, generator=gen).erfinv_()
    t.mul_(math.sqrt(2.0)).clamp_(-bound, bound).mul_(std)


def apply_reference_init(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Reference init scheme (models/ADNMUNet.py:294-323,794-804), the
    counterpart of the JAX ``apply_reference_init``: every Dense kernel
    (a 2-D ``kernel`` leaf of the JAX tree) gets trunc_normal(0.02), then
    the ``out_proj`` and ``fc2`` kernels kaiming_uniform(a=sqrt(5)) /
    sqrt(3) (the reference's n_layer), and the biases of those Dense
    modules are zeroed. The
    leaves are found by their JAX paths (``convert.jax_keys``); the values
    come from ``gen``, so they differ from JAX's draws."""
    params = dict(model.named_parameters())
    keys = jax_keys(model)

    def is_dense_kernel(name: str) -> bool:
        return keys[name].endswith("/kernel") and params[name].dim() == 2

    dense = {keys[name].rpartition("/")[0] for name in params if is_dense_kernel(name)}
    with torch.no_grad():
        for name, p in params.items():
            module_path, _, leaf = keys[name].rpartition("/")
            if is_dense_kernel(name):
                if module_path.rpartition("/")[2] in ("out_proj", "fc2"):
                    bound = 1.0 / math.sqrt(p.shape[1])  # fan_in: the JAX kernel's rows
                    p.uniform_(-bound, bound, generator=gen).div_(math.sqrt(3.0))
                else:
                    _trunc_normal_(p, gen, 0.02)
            elif leaf == "bias" and module_path in dense:
                p.zero_()
    return model
