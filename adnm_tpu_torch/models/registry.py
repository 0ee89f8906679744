"""Model registry (counterpart of adnm_tpu/models/registry.py; reference:
train_untils.py:22-130, the model half of create_models).

Every model maps (B, T_in, 1, H, W) to (B, T_out, 1, H, W). The port
builds all seven: the ADNM-UNet and six baselines. Each computes in its
input's dtype, fp32 or bf16, with the JAX model's dtype at every module
output (the JAX ``--bf16``); only the ADNM-UNet has a configuration that
refuses bf16 (``ADNMUNet.check_compute_dtype``).
"""

from __future__ import annotations

from torch import nn

MODEL_NAMES = ("ADNMUnet", "ConvLSTM", "TrajGRU", "LPTQPN", "TransUnet", "SmaATUnet",
               "SwinUnet")
BASELINES = tuple(name for name in MODEL_NAMES if name != "ADNMUnet")


def create_model(model_name: str, input_frames: int, output_frames: int, frame_interval: int,
                 img_size: int = 256, **model_kwargs) -> nn.Module:
    """``model_kwargs`` go to the ADNMUnet factory (``refiner_remat``,
    ``linear_attn_duality``, ``mixer_type``, ``attn_type``,
    ``simple_patch``, ``compute_dead_features``) and to no other model.
    ``img_size`` fixes ConvLSTM's peephole weights, TransUnet's position
    embeddings and SwinUnet's windows, which are shaped by their grids;
    the other models take any frame size their strides divide."""
    if model_name == "ADNMUnet":
        from adnm_tpu_torch.models.adnm_unet import create_adnm_unet

        return create_adnm_unet(input_frames, output_frames, frame_interval, img_size=img_size,
                                **model_kwargs)
    if model_kwargs:
        raise ValueError(f"model kwargs {sorted(model_kwargs)} are only supported for ADNMUnet")
    if model_name == "SmaATUnet":
        from adnm_tpu_torch.models.smaat_unet import SmaAtUNet

        return SmaAtUNet(n_channels=input_frames, n_classes=output_frames)
    if model_name == "ConvLSTM":
        from adnm_tpu_torch.models.conv_lstm import create_conv_lstm

        return create_conv_lstm(output_frames, img_size)
    if model_name == "TrajGRU":
        from adnm_tpu_torch.models.traj_gru import create_traj_gru

        return create_traj_gru(output_frames)
    if model_name == "LPTQPN":
        from adnm_tpu_torch.models.lptqpn import LPTQPN

        return LPTQPN(inp_channels=input_frames, out_channels=output_frames)
    if model_name == "TransUnet":
        from adnm_tpu_torch.models.trans_unet import create_trans_unet

        return create_trans_unet(output_frames, img_size, input_frames)
    if model_name == "SwinUnet":
        from adnm_tpu_torch.models.swin_unet import create_swin_unet

        return create_swin_unet(output_frames, img_size, input_frames)
    raise ValueError(f"unknown model {model_name!r}; known: {MODEL_NAMES}")
