"""TrajGRU encoder-forecaster (counterpart of adnm_tpu/models/traj_gru.py;
reference: models/TrajGRU.py).

A GRU whose hidden-to-hidden connections warp the previous state along L
flow fields that it generates at each step (reference: TrajGRU.py:90-209),
with the reference's specs: L = 13, 13, 9 in the encoder and 13, 13, 9 in
the forecaster (TrajGRU.py:348-398). The L warps of a step run as one
``F.grid_sample`` with the flows folded into the batch; time runs as a
Python loop (JAX: ``nn.scan``). No parameter depends on the frame size.
In bf16 compute the fp32 zero state (JAX's ``jnp.zeros``) promotes every
step: the first convolution and the first i2h are bf16, the rest fp32, as
in JAX.

The warp's backward: ``grid_sample``'s own sums the image gradient with
atomics on CUDA, in an order that changes from run to run, so two training
steps of one batch would differ. ``bilinear_warp`` keeps its forward and
its flow gradient (one output pixel each) and sums the image gradient with
``index_put_(accumulate=True)`` under torch's deterministic-algorithms
mode, held for that call alone: there CUDA sorts the indices and adds each
one's terms in a fixed order, and the CPU adds them on one thread (its
threaded default is no more deterministic than the atomics).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from adnm_tpu_torch.core.layers import Conv2d, ConvTranspose2d
from adnm_tpu_torch.device import deterministic_algorithms
from adnm_tpu_torch.models.conv_lstm import apply_seq, leaky

_BILINEAR, _ZEROS = 0, 0  # grid_sampler's interpolation and padding modes


def _scatter_image_grad(g: torch.Tensor, grid: torch.Tensor, size) -> torch.Tensor:
    """The image gradient of bilinear ``grid_sample`` (zeros padding,
    align_corners=True): each output pixel's gradient ``g`` (N, C, Ho, Wo)
    added to its four corners with their weights, in a fixed order."""
    n, c, h, w = size
    ix = (grid[..., 0] + 1) / 2 * (w - 1)  # grid_sampler's unnormalisation
    iy = (grid[..., 1] + 1) / 2 * (h - 1)
    x0, y0 = ix.floor(), iy.floor()
    x1, y1 = x0 + 1, y0 + 1
    corners = ((y0, x0, (x1 - ix) * (y1 - iy)), (y0, x1, (ix - x0) * (y1 - iy)),
               (y1, x0, (x1 - ix) * (iy - y0)), (y1, x1, (ix - x0) * (iy - y0)))
    base = torch.arange(n, device=g.device).view(n, 1, 1) * (h * w)
    idx, wgt = [], []
    for yi, xi, wi in corners:
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx.append(base + yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long())
        wgt.append(wi * valid.to(wi.dtype))
    src = torch.stack(wgt)[..., None] * g.permute(0, 2, 3, 1)[None]  # (4, N, Ho, Wo, C)
    out = g.new_zeros(n * h * w, c)
    with deterministic_algorithms():
        out.index_put_((torch.stack(idx).reshape(-1),), src.reshape(-1, c), accumulate=True)
    return out.view(n, h, w, c).permute(0, 3, 1, 2)


class _GridSample(torch.autograd.Function):
    """Bilinear ``F.grid_sample`` (zeros padding, align_corners=True) with a
    backward that sums the same terms in a fixed order."""

    @staticmethod
    def forward(ctx, img, grid):
        ctx.save_for_backward(img, grid)
        return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    @staticmethod
    def backward(ctx, g):
        img, grid = ctx.saved_tensors
        g = g.contiguous()
        grad_img = grad_grid = None
        if ctx.needs_input_grad[1]:
            _, grad_grid = torch.ops.aten.grid_sampler_2d_backward(
                g, img, grid, _BILINEAR, _ZEROS, True, [False, True])
        if ctx.needs_input_grad[0]:
            grad_img = _scatter_image_grad(g, grid, img.shape)
        return grad_img, grad_grid


def bilinear_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``img`` (N, C, H, W) sampled at the identity grid plus ``flow`` (N, H,
    W, 2), pixel offsets (x, y), bilinearly with zeros outside the frame
    (reference: TrajGRU.py:36-53, wrap()): ``F.grid_sample`` with
    align_corners=True on the grid 2 (arange + flow) / (size - 1) - 1. An
    axis of one pixel (TrajGRU's deepest state at 32^2 frames) has no grid
    spacing: the image is padded there with one zero pixel, which is what
    zeros padding reads beyond it, so the warp stays JAX's."""
    _, _, h, w = img.shape
    img = F.pad(img, (0, int(w == 1), 0, int(h == 1)))
    hp, wp = img.shape[-2:]
    gx = 2 * (torch.arange(w, device=flow.device, dtype=flow.dtype) + flow[..., 0]) / (wp - 1) - 1
    gy = 2 * (torch.arange(h, device=flow.device, dtype=flow.dtype)[:, None]
              + flow[..., 1]) / (hp - 1) - 1
    return _GridSample.apply(img, torch.stack([gx, gy], dim=-1))


class TrajGRUCell(nn.Module):
    """One TrajGRU step (reference: TrajGRU.py:150-206). A cell that never
    takes inputs (the forecaster's first) has no ``i2f_conv1``."""

    jax_scanned = True  # JAX runs it under nn.scan (utils.profiling.analytic_flops)

    def __init__(self, input_channel: Optional[int], num_filter: int, L: int = 5):
        super().__init__()
        self.L = L
        self.h2f_conv1 = Conv2d(num_filter, 32, 5, 1, 2)
        if input_channel is not None:
            self.i2f_conv1 = Conv2d(input_channel, 32, 5, 1, 2)
        self.flows_conv = Conv2d(32, L * 2, 5, 1, 2)
        self.ret = Conv2d(L * num_filter, num_filter * 3, 1)

    def forward(self, h: torch.Tensor, i2h_t: Optional[torch.Tensor],
                x_t: Optional[torch.Tensor]) -> torch.Tensor:
        b, nf, hh, ww = h.shape
        f = self.h2f_conv1(h)
        if x_t is not None:
            f = f + self.i2f_conv1(x_t)
        flows = self.flows_conv(leaky(f))  # (B, 2L, H, W): (x, y) of each trajectory
        fl = flows.reshape(b * self.L, 2, hh, ww).permute(0, 2, 3, 1)
        rep = h[:, None].expand(b, self.L, nf, hh, ww).reshape(b * self.L, nf, hh, ww)
        warped = bilinear_warp(rep, -fl).reshape(b, self.L * nf, hh, ww)
        h2h_r, h2h_u, h2h_m = self.ret(warped).chunk(3, dim=1)
        if i2h_t is not None:
            i2h_r, i2h_u, i2h_m = i2h_t.chunk(3, dim=1)
            reset = torch.sigmoid(i2h_r + h2h_r)
            update = torch.sigmoid(i2h_u + h2h_u)
            new_mem = leaky(i2h_m + reset * h2h_m)
        else:
            reset = torch.sigmoid(h2h_r)
            update = torch.sigmoid(h2h_u)
            new_mem = leaky(reset * h2h_m)
        return update * h + (1 - update) * new_mem


class TrajGRULayer(nn.Module):
    """A cell over time: inputs (T, B, C, H, W), their i2h convolution
    batched over all steps (reference :170-174); or, with
    ``input_channel`` None, ``seq_len`` steps without inputs. The state
    starts at zeros when None (then the inputs are given)."""

    def __init__(self, input_channel: Optional[int], num_filter: int, L: int = 5):
        super().__init__()
        self.num_filter = num_filter
        if input_channel is not None:
            self.i2h = Conv2d(input_channel, num_filter * 3, 3, 1, 1)
        self.cell = TrajGRUCell(input_channel, num_filter, L)

    def forward(self, inputs: Optional[torch.Tensor], state: Optional[torch.Tensor],
                seq_len: int):
        if state is None:  # fp32 zeros, as JAX's, whatever the inputs' dtype
            t, b, _, hh, ww = inputs.shape
            state = inputs.new_zeros(b, self.num_filter, hh, ww,
                                     dtype=torch.promote_types(inputs.dtype, torch.float32))
        h, outs = state, []
        i2h = None if inputs is None else apply_seq(self.i2h, inputs)
        for t in range(seq_len):
            if inputs is None:
                h = self.cell(h, None, None)
            else:
                h = self.cell(h, i2h[t], inputs[t])
            outs.append(h)
        return torch.stack(outs), h


class TrajGRUEF(nn.Module):
    """Reference: TrajGRU.py:330-343, specs :348-398:
    (B, T_in, 1, H, W) -> (B, T_out, 1, H, W), H and W multiples of 32."""

    def __init__(self, output_seq_len: int):
        super().__init__()
        self.output_seq_len = output_seq_len
        self.e1_conv = Conv2d(1, 8, 6, 4, 1)
        self.e_rnn1 = TrajGRULayer(8, 64, L=13)
        self.e2_conv = Conv2d(64, 192, 4, 4, 1)
        self.e_rnn2 = TrajGRULayer(192, 192, L=13)
        self.e3_conv = Conv2d(192, 192, 3, 2, 1)
        self.e_rnn3 = TrajGRULayer(192, 192, L=9)
        self.f_rnn3 = TrajGRULayer(None, 192, L=13)
        self.f_deconv1 = ConvTranspose2d(192, 192, 4, 2, 1)
        self.f_rnn2 = TrajGRULayer(192, 192, L=13)
        self.f_deconv2 = ConvTranspose2d(192, 64, 6, 4, 1)
        self.f_rnn1 = TrajGRULayer(64, 64, L=9)
        self.f_deconv3 = ConvTranspose2d(64, 8, 6, 4, 1)
        self.f_conv2 = Conv2d(8, 8, 3, 1, 1)
        self.f_conv3 = Conv2d(8, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t_in = x.shape[1]
        x = x.transpose(0, 1)  # (T, B, 1, H, W)
        o1, st1 = self.e_rnn1(apply_seq(lambda v: leaky(self.e1_conv(v)), x), None, t_in)
        o2, st2 = self.e_rnn2(apply_seq(lambda v: leaky(self.e2_conv(v)), o1), None, t_in)
        _, st3 = self.e_rnn3(apply_seq(lambda v: leaky(self.e3_conv(v)), o2), None, t_in)

        t_out = self.output_seq_len
        f3, _ = self.f_rnn3(None, st3, t_out)
        f2, _ = self.f_rnn2(apply_seq(lambda v: leaky(self.f_deconv1(v)), f3), st2, t_out)
        f1, _ = self.f_rnn1(apply_seq(lambda v: leaky(self.f_deconv2(v)), f2), st1, t_out)

        def head(v):
            v = leaky(self.f_conv2(leaky(self.f_deconv3(v))))
            return self.f_conv3(v)

        return apply_seq(head, f1).transpose(0, 1)  # (B, T_out, 1, H, W)


def create_traj_gru(output_frames: int) -> TrajGRUEF:
    """Reference: TrajGRU.py:408-409 (create_TrajGRU)."""
    return TrajGRUEF(output_seq_len=output_frames)
