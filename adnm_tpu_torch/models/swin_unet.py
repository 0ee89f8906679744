"""SwinUnet: a Swin-T U-Net with shifted-window attention, on (B, L, C)
tokens inside and NCHW at its ends (counterpart of
adnm_tpu/models/swin_unet.py; reference: models/SwinUnet.py).

(B, T_in, 1, H, W) -> (B, num_classes, 1, H, W). Patch 4, embed 96,
depths (2, 2, 2, 2), heads (3, 6, 12, 24), window 8, MLP ratio 4, DropPath
rising linearly from 0 to 0.2 over the encoder's blocks (the decoder's
blocks reuse the encoder's rates and, as in the reference, the encoder's
depths); drop and attention-drop rates 0. At a stage whose resolution is
no larger than the window, the shift is 0 and the window is the whole
resolution, so the relative-position tables are shaped by ``img_size``.

The relative-position bias gathers a (tokens^2, heads) bias from its
table; the gather's gradient would be a scatter-add, whose sums on CUDA
run in an order that changes from run to run, so the gather is a product
with a one-hot matrix (exact in the forward, a fixed-order matrix product
in the backward). The shifted windows' mask is a static array, made on the
host once per shape. DropPath draws its masks from the ``Trainer``'s
generator (``core.stochastic``). In bf16 compute only the patch
embedding's convolution is bf16: its LayerNorm returns fp32 (flax's
promotion), and so does all that follows, as in JAX.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from adnm_tpu_torch.core.layers import ACTS, Conv2d, LayerNorm, Linear
from adnm_tpu_torch.core.stochastic import Dropout, DropPath


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * windows, ws * ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B * windows, ws * ws, C) -> (B, H, W, C)."""
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _relative_position_index(ws: int) -> np.ndarray:
    """(ws^2, ws^2) index into the (2 ws - 1)^2-row bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """The shifted windows' mask (windows, ws^2, ws^2): -100 between tokens
    from different regions of the rolled image, else 0 (reference:
    SwinUnet.py:477-495)."""
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wslice in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wslice, :] = cnt
            cnt += 1
    m = img_mask.reshape(1, h // ws, ws, w // ws, ws, 1)
    mw = m.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    attn_mask = mw[:, None, :] - mw[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


def _on_device(array: np.ndarray, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    # made outside inference mode, so that a model served under
    # torch.inference_mode still trains with the cached tensor
    with torch.inference_mode(False):
        return torch.from_numpy(array).to(device, dtype)


@functools.lru_cache(maxsize=16)
def _bias_onehot(ws: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """(ws^4, (2 ws - 1)^2) one-hot rows of ``_relative_position_index``."""
    idx = _relative_position_index(ws).reshape(-1)
    onehot = np.zeros((idx.size, (2 * ws - 1) ** 2), np.float32)
    onehot[np.arange(idx.size), idx] = 1.0
    return _on_device(onehot, device, dtype)


@functools.lru_cache(maxsize=16)
def _mask_tensor(h: int, w: int, ws: int, shift: int, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    return _on_device(_shift_attn_mask(h, w, ws, shift), device, dtype)


class WindowAttention(nn.Module):
    """Window multi-head self-attention with a relative-position bias
    (reference: SwinUnet.py:326-421)."""

    def __init__(self, dim: int, window_size: int, num_heads: int, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.qkv = Linear(dim, dim * 3)
        self.attn_drop = Dropout(attn_drop)
        self.proj = Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)

    def reset_random_(self, gen: torch.Generator):
        from adnm_tpu_torch.models.adnm_unet import _trunc_normal_

        _trunc_normal_(self.relative_position_bias_table, gen, 0.02)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        b_, n, c = x.shape
        hd = c // self.num_heads
        table = self.relative_position_bias_table
        onehot = _bias_onehot(self.window_size, x.device, table.dtype)
        bias = torch.matmul(onehot, table).reshape(n, n, self.num_heads).permute(2, 0, 1)
        qkv = self.qkv(x).reshape(b_, n, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)
        attn = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2)) + bias
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, self.num_heads, n, n) + mask[None, :, None]
            attn = attn.reshape(-1, self.num_heads, n, n)
        attn = self.attn_drop(attn.softmax(dim=-1))
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b_, n, c)
        return self.proj_drop(self.proj(out))


class SwinBlock(nn.Module):
    """(Shifted-)window attention and an MLP, each behind a LayerNorm and
    through DropPath (reference: SwinUnet.py:424-531, SwinTransformerBlock).
    The cyclic shift is ``torch.roll``."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int], num_heads: int,
                 window_size: int = 8, shift_size: int = 0, mlp_ratio: float = 4.0,
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.h, self.w = input_resolution
        if min(self.h, self.w) <= window_size:
            shift_size, window_size = 0, min(self.h, self.w)
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = LayerNorm(dim, 1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads, attn_drop, drop)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, 1e-5)
        self.fc1 = Linear(dim, int(dim * mlp_ratio))
        self.fc2 = Linear(int(dim * mlp_ratio), dim)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w, ws, shift = self.h, self.w, self.window_size, self.shift_size
        b, l, c = x.shape
        y = self.norm1(x).reshape(b, h, w, c)
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = _mask_tensor(h, w, ws, shift, x.device, x.dtype)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, h, w)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + self.drop_path(y.reshape(b, l, c))
        y = self.drop(ACTS["gelu"](self.fc1(self.norm2(x))))
        return x + self.drop_path(self.drop(self.fc2(y)))


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated, LayerNorm, 4C -> 2C (reference:
    SwinUnet.py:552-588)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int):
        super().__init__()
        self.h, self.w = input_resolution
        self.norm = LayerNorm(4 * dim, 1e-5)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, c = x.shape
        x = x.reshape(b, self.h, self.w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1).reshape(b, -1, 4 * c)
        return self.reduction(self.norm(x))


class PatchExpand(nn.Module):
    """C -> 2C, then each token into 2x2 tokens of C/2, LayerNorm (reference:
    SwinUnet.py:601-623)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int):
        super().__init__()
        self.h, self.w = input_resolution
        self.expand = Linear(dim, 2 * dim, bias=False)
        self.norm = LayerNorm(dim // 2, 1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.expand(x)
        b, _, c = x.shape
        x = x.reshape(b, self.h, self.w, 2, 2, c // 4).permute(0, 1, 3, 2, 4, 5)
        return self.norm(x.reshape(b, -1, c // 4))


class FinalPatchExpandX4(nn.Module):
    """C -> 16C, then each token into 4x4 tokens of C, LayerNorm (reference:
    SwinUnet.py:626-651)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int):
        super().__init__()
        self.h, self.w = input_resolution
        self.dim = dim
        self.expand = Linear(dim, 16 * dim, bias=False)
        self.norm = LayerNorm(dim, 1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.expand(x)
        b = x.shape[0]
        x = x.reshape(b, self.h, self.w, 4, 4, self.dim).permute(0, 1, 3, 2, 4, 5)
        return self.norm(x.reshape(b, -1, self.dim))


class SwinTransformerSys(nn.Module):
    """Reference: SwinUnet.py:831-1033. Takes (B, in_chans, H, W), returns
    (B, num_classes, H, W)."""

    def __init__(self, img_size: int = 256, patch_size: int = 4, in_chans: int = 5,
                 num_classes: int = 20, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 8,
                 mlp_ratio: float = 4.0, drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.2, patch_norm: bool = True):
        super().__init__()
        nl = self.n_layers = len(depths)
        self.depths, self.embed_dim = tuple(depths), embed_dim
        pr = self.patches = img_size // patch_size
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.patch_embed_proj = Conv2d(in_chans, embed_dim, patch_size, patch_size, 0)
        self.patch_embed_norm = LayerNorm(embed_dim, 1e-5) if patch_norm else None
        self.pos_drop = Dropout(drop_rate)

        def stage(name, dim, res, depth, heads, rates):
            for i in range(depth):
                self.add_module(f"{name}_blk{i}", SwinBlock(
                    dim, res, heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                    mlp_ratio, drop_rate, attn_drop_rate, rates[i]))

        for il in range(nl):
            dim, res = embed_dim * 2 ** il, (pr // 2 ** il, pr // 2 ** il)
            stage(f"layer{il}", dim, res, depths[il], num_heads[il],
                  dpr[sum(depths[:il]):sum(depths[:il + 1])])
            if il < nl - 1:
                self.add_module(f"merge{il}", PatchMerging(res, dim))
        self.norm = LayerNorm(embed_dim * 2 ** (nl - 1), 1e-5)
        for il in range(nl):  # the decoder, with the encoder's depths
            inv = nl - 1 - il
            dim, res = embed_dim * 2 ** inv, (pr // 2 ** inv, pr // 2 ** inv)
            if il == 0:
                self.up0 = PatchExpand(res, dim)
                continue
            self.add_module(f"concat_back_dim{il}", Linear(2 * dim, dim))
            stage(f"layer_up{il}", dim, res, depths[inv], num_heads[inv],
                  dpr[sum(depths[:inv]):sum(depths[:inv + 1])])
            if il < nl - 1:
                self.add_module(f"up{il}", PatchExpand(res, dim))
        self.norm_up = LayerNorm(embed_dim, 1e-5)
        self.up_final = FinalPatchExpandX4((pr, pr), embed_dim)
        self.output = Conv2d(embed_dim, num_classes, 1, 1, 0, bias=False)

    def _stage(self, x: torch.Tensor, name: str, depth: int) -> torch.Tensor:
        for i in range(depth):
            x = getattr(self, f"{name}_blk{i}")(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nl, pr = self.n_layers, self.patches
        x = self.patch_embed_proj(x).flatten(2).transpose(1, 2)  # (B, pr^2, embed)
        if self.patch_embed_norm is not None:
            x = self.patch_embed_norm(x)
        x = self.pos_drop(x)
        skips = []
        for il in range(nl):
            skips.append(x)
            x = self._stage(x, f"layer{il}", self.depths[il])
            if il < nl - 1:
                x = getattr(self, f"merge{il}")(x)
        x = self.norm(x)
        for il in range(nl):
            if il == 0:
                x = self.up0(x)
                continue
            x = torch.cat([x, skips[nl - 1 - il]], dim=-1)
            x = getattr(self, f"concat_back_dim{il}")(x)
            x = self._stage(x, f"layer_up{il}", self.depths[nl - 1 - il])
            if il < nl - 1:
                x = getattr(self, f"up{il}")(x)
        x = self.up_final(self.norm_up(x))
        b = x.shape[0]
        x = x.transpose(1, 2).reshape(b, self.embed_dim, 4 * pr, 4 * pr)
        return self.output(x)


class SwinUnet(nn.Module):
    """Reference: SwinUnet.py:1038-1068. ``in_chans`` is the number of input
    frames (3 for a single frame, which is repeated)."""

    def __init__(self, num_classes: int, img_size: int = 256, in_chans: int = 5,
                 **swin_kwargs):
        super().__init__()
        self.swin_unet = SwinTransformerSys(img_size=img_size, in_chans=in_chans,
                                            num_classes=num_classes, **swin_kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, :, 0]
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        return self.swin_unet(x)[:, :, None]


def create_swin_unet(output_frames: int, img_size: int = 256,
                     input_frames: int = 5) -> SwinUnet:
    """The reference's import-time config as explicit construction
    (reference: SwinUnet.py:1109-1227)."""
    return SwinUnet(num_classes=output_frames, img_size=img_size,
                    in_chans=3 if input_frames == 1 else input_frames)
