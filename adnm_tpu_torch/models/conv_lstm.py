"""ConvLSTM encoder-forecaster (counterpart of adnm_tpu/models/conv_lstm.py;
reference: models/ConvLSTM.py).

Three conv-downsample stages, each feeding a ConvLSTM over T_in; the
forecaster runs the mirrored stack for T_out steps from the encoder's last
states (reference: ConvLSTM.py:100-197). JAX runs time with ``nn.scan``;
the port runs it as a Python loop. The peephole weights ``Wci``, ``Wcf``
and ``Wco`` are learnable and zero-initialised, as in JAX, and shaped by
the stage grids (H/4, H/16, H/32): the model serves only the ``img_size``
it was built for, and its forward raises on another. In bf16 compute the
fp32 zero states (JAX's ``jnp.zeros``) promote every step: only the first
convolution is bf16, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from adnm_tpu_torch.core.layers import Conv2d, ConvTranspose2d


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def apply_seq(fn, x: torch.Tensor) -> torch.Tensor:
    """A per-frame stack ``fn`` on (T, B, C, H, W), with T folded into B."""
    t, b = x.shape[:2]
    y = fn(x.reshape(t * b, *x.shape[2:]))
    return y.reshape(t, b, *y.shape[1:])


class ConvLSTMCell(nn.Module):
    """Peephole ConvLSTM cell (reference: ConvLSTM.py:14-65). The peepholes
    are (nf, sh, sw) here and (sh, sw, nf) in JAX (``jax_layouts``)."""

    jax_scanned = True  # JAX runs it under nn.scan (utils.profiling.analytic_flops)

    # port axes of each JAX leaf's axes: port = jax.permute(*perm)
    jax_layouts = {"Wci": (2, 0, 1), "Wcf": (2, 0, 1), "Wco": (2, 0, 1)}

    def __init__(self, input_channel: int, num_filter: int, state_hw: Tuple[int, int],
                 kernel_size: int = 3):
        super().__init__()
        self.input_channel = input_channel
        self.conv = Conv2d(input_channel + num_filter, num_filter * 4, kernel_size, 1,
                           (kernel_size - 1) // 2)
        for name in self.jax_layouts:
            setattr(self, name, nn.Parameter(torch.zeros(num_filter, *state_hw)))

    def forward(self, x: Optional[torch.Tensor], h: torch.Tensor,
                c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if x is None:
            x = h.new_zeros(h.shape[0], self.input_channel, *h.shape[2:])
        i, f, tmp_c, o = self.conv(torch.cat([x, h], dim=1)).chunk(4, dim=1)
        i = torch.sigmoid(i + self.Wci * c)
        f = torch.sigmoid(f + self.Wcf * c)
        c = f * c + i * torch.tanh(tmp_c)
        o = torch.sigmoid(o + self.Wco * c)
        return o * torch.tanh(c), c


class ConvLSTMLayer(nn.Module):
    """A cell over time: inputs (T, B, C, H, W), or None for ``seq_len``
    steps of zero inputs; states (h, c), or None for zeros (then the
    inputs are given)."""

    def __init__(self, input_channel: int, num_filter: int, state_hw: Tuple[int, int],
                 kernel_size: int = 3):
        super().__init__()
        self.num_filter = num_filter
        self.state_hw = state_hw
        self.cell = ConvLSTMCell(input_channel, num_filter, state_hw, kernel_size)

    def forward(self, inputs: Optional[torch.Tensor], states, seq_len: int):
        if states is None:  # fp32 zeros, as JAX's, whatever the inputs' dtype
            h = inputs.new_zeros(inputs.shape[1], self.num_filter, *self.state_hw,
                                 dtype=torch.promote_types(inputs.dtype, torch.float32))
            states = (h, h)
        h, c = states
        outs = []
        for t in range(seq_len):
            h, c = self.cell(None if inputs is None else inputs[t], h, c)
            outs.append(h)
        return torch.stack(outs), (h, c)


class ConvLSTMEF(nn.Module):
    """Encoder-forecaster (reference: ConvLSTM.py:184-197, specs :211-247):
    (B, T_in, 1, H, W) -> (B, T_out, 1, H, W) with H = W = ``img_size``, a
    multiple of 32."""

    def __init__(self, output_seq_len: int, img_size: int = 256):
        super().__init__()
        if img_size % 32:
            raise ValueError(f"img_size {img_size}: ConvLSTM needs a multiple of 32")
        self.output_seq_len = output_seq_len
        self.img_size = img_size
        s1, s2, s3 = img_size // 4, img_size // 16, img_size // 32
        self.e1_conv = Conv2d(1, 8, 6, 4, 1)
        self.e_rnn1 = ConvLSTMLayer(8, 64, (s1, s1))
        self.e2_conv = Conv2d(64, 192, 4, 4, 1)
        self.e_rnn2 = ConvLSTMLayer(192, 192, (s2, s2))
        self.e3_conv = Conv2d(192, 192, 3, 2, 1)
        self.e_rnn3 = ConvLSTMLayer(192, 192, (s3, s3))
        self.f_rnn3 = ConvLSTMLayer(192, 192, (s3, s3))
        self.f_deconv1 = ConvTranspose2d(192, 192, 4, 2, 1)
        self.f_rnn2 = ConvLSTMLayer(192, 192, (s2, s2))
        self.f_deconv2 = ConvTranspose2d(192, 64, 6, 4, 1)
        self.f_rnn1 = ConvLSTMLayer(64, 64, (s1, s1))
        self.f_deconv3 = ConvTranspose2d(64, 8, 6, 4, 1)
        self.f_conv2 = Conv2d(8, 8, 3, 1, 1)
        self.f_conv3 = Conv2d(8, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t_in, (h, w) = x.shape[1], x.shape[-2:]
        if (h, w) != (self.img_size, self.img_size):
            raise ValueError(f"ConvLSTM built for {self.img_size}^2 frames got {h}x{w}: its "
                             f"peephole weights are shaped by the frame size")
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


def create_conv_lstm(output_frames: int, img_size: int = 256) -> ConvLSTMEF:
    """Reference: ConvLSTM.py:258-259 (create_ConvLSTM)."""
    return ConvLSTMEF(output_seq_len=output_frames, img_size=img_size)
