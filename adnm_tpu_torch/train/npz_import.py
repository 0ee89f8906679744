"""Pretrained-encoder loaders for TransUnet and SwinUnet (counterpart of
adnm_tpu/train/npz_import.py), on the JAX-layout params trees of
``adnm_tpu_torch.convert``: ``to_jax_params(model)`` in, the updated tree
out, ``from_jax_params(model, tree)`` to load it.

* ``load_transunet_npz``: the encoder of a google-ViT R50+ViT-B/16 ``.npz``
  (reference: models/TransUnet.py:718-765, ``load_from``): the patch
  embedding, the position embeddings (the cls token stripped, the square
  grid zoomed bilinearly where the sizes differ), every ViT block, the
  encoder norm and the ResNetV2 root and units. The DecoderCup and the
  head keep their values. The root conv's RGB kernel is tiled to the input
  frames and rescaled (``_adapt_in_channels``): the reference's own
  ``load_from`` fails there, its root taking 5 frames.
* ``load_swinunet_pretrained``: an upstream swin-tiny checkpoint
  (reference: models/SwinUnet.py:1070-1105): every encoder ``layers.{i}``
  tensor also loads onto the decoder's ``layers_up.{3-i}``; shape
  mismatches are skipped and the rest loads non-strictly.
"""

from __future__ import annotations

import copy
from typing import Mapping

import numpy as np
import torch

from adnm_tpu_torch.train.torch_import import _IN, swinunet_name_map

_Q = "MultiHeadDotProductAttention_1/query"
_K = "MultiHeadDotProductAttention_1/key"
_V = "MultiHeadDotProductAttention_1/value"
_OUT = "MultiHeadDotProductAttention_1/out"
_FC0 = "MlpBlock_3/Dense_0"
_FC1 = "MlpBlock_3/Dense_1"
_ATT_NORM = "LayerNorm_0"
_MLP_NORM = "LayerNorm_2"


def _resize_posemb(posemb: np.ndarray, n_tok_new: int) -> np.ndarray:
    """Reference: TransUnet.py:728-750: strip the cls token if present,
    then zoom the square grid bilinearly (scipy.ndimage, order 1)."""
    posemb = np.asarray(posemb, np.float32)
    n_tok = posemb.shape[1]
    if n_tok == n_tok_new:
        return posemb
    if n_tok - 1 == n_tok_new:
        return posemb[:, 1:]
    grid = posemb[0, 1:] if int(np.sqrt(n_tok)) ** 2 != n_tok else posemb[0]
    gs_old, gs_new = int(np.sqrt(grid.shape[0])), int(np.sqrt(n_tok_new))
    if gs_old * gs_old != grid.shape[0] or gs_new * gs_new != n_tok_new:
        raise ValueError(f"position embeddings of {n_tok} tokens do not fit a square grid of "
                         f"{n_tok_new}")
    from scipy import ndimage

    grid = ndimage.zoom(grid.reshape(gs_old, gs_old, -1),
                        (gs_new / gs_old, gs_new / gs_old, 1), order=1)
    return grid.reshape(1, n_tok_new, -1).astype(np.float32)


def _adapt_in_channels(kernel: np.ndarray, cin_new: int) -> np.ndarray:
    """An HWIO kernel tiled over its input channels to ``cin_new`` and
    scaled by cin_old / cin_new (timm's in_chans convention: the sum of the
    responses is kept in expectation)."""
    cin_old = kernel.shape[2]
    if cin_old == cin_new:
        return kernel
    reps = int(np.ceil(cin_new / cin_old))
    tiled = np.concatenate([kernel] * reps, axis=2)[:, :, :cin_new]
    return (tiled * (cin_old / float(cin_new))).astype(kernel.dtype)


def _put(params: dict, path: str, value, reshape=None) -> None:
    node = params
    *parents, leaf = path.split("/")
    for p in parents:
        node = node[p]
    value = np.asarray(value, np.float32)
    if reshape is not None:
        value = value.reshape(reshape)
    if node[leaf].shape != value.shape:
        raise ValueError(f"{path}: ours {node[leaf].shape} vs npz {value.shape}")
    node[leaf] = value


def load_transunet_npz(weights: Mapping[str, np.ndarray], params: dict,
                       block_units=(3, 4, 9), num_layers: int = 12) -> dict:
    """A copy of TransUnet's ``params`` tree with the encoder from a
    google-ViT ``.npz`` mapping (R50+ViT-B/16 layout). Raises KeyError on a
    missing entry and ValueError on a shape mismatch."""
    params = copy.deepcopy(params)
    hidden = int(np.asarray(weights["embedding/kernel"]).shape[-1])

    def put(path, value, reshape=None):
        _put(params, path, value, reshape)

    put("patch_embeddings/kernel", weights["embedding/kernel"])
    put("patch_embeddings/bias", weights["embedding/bias"])
    put("encoder_norm/scale", weights["Transformer/encoder_norm/scale"])
    put("encoder_norm/bias", weights["Transformer/encoder_norm/bias"])
    n_tok_new = int(params["position_embeddings"].shape[1])
    put("position_embeddings",
        _resize_posemb(np.asarray(weights["Transformer/posembed_input/pos_embedding"]),
                       n_tok_new))
    for i in range(num_layers):
        root, blk = f"Transformer/encoderblock_{i}", f"block_{i}"
        for ours, theirs in (("query", _Q), ("key", _K), ("value", _V)):
            put(f"{blk}/{ours}/kernel", weights[f"{root}/{theirs}/kernel"], (hidden, hidden))
            put(f"{blk}/{ours}/bias", weights[f"{root}/{theirs}/bias"], (hidden,))
        put(f"{blk}/out/kernel", weights[f"{root}/{_OUT}/kernel"], (hidden, hidden))
        put(f"{blk}/out/bias", weights[f"{root}/{_OUT}/bias"], (hidden,))
        for ours, theirs in (("fc1", _FC0), ("fc2", _FC1)):
            put(f"{blk}/{ours}/kernel", weights[f"{root}/{theirs}/kernel"])
            put(f"{blk}/{ours}/bias", weights[f"{root}/{theirs}/bias"])
        for ours, theirs in (("attention_norm", _ATT_NORM), ("ffn_norm", _MLP_NORM)):
            put(f"{blk}/{ours}/scale", weights[f"{root}/{theirs}/scale"])
            put(f"{blk}/{ours}/bias", weights[f"{root}/{theirs}/bias"])

    cin_new = int(params["hybrid_model"]["root_conv"]["kernel"].shape[2])
    put("hybrid_model/root_conv/kernel",
        _adapt_in_channels(np.asarray(weights["conv_root/kernel"], np.float32), cin_new))
    put("hybrid_model/root_gn/weight", weights["gn_root/scale"], (-1,))
    put("hybrid_model/root_gn/bias", weights["gn_root/bias"], (-1,))
    for bi, n_units in enumerate(block_units):
        for ui in range(n_units):
            src, dst = f"block{bi + 1}/unit{ui + 1}", f"hybrid_model/block{bi + 1}_unit{ui + 1}"
            for c in ("conv1", "conv2", "conv3"):
                put(f"{dst}/{c}/kernel", weights[f"{src}/{c}/kernel"])
            for g in ("gn1", "gn2", "gn3"):
                put(f"{dst}/{g}/weight", weights[f"{src}/{g}/scale"], (-1,))
                put(f"{dst}/{g}/bias", weights[f"{src}/{g}/bias"], (-1,))
            if f"{src}/conv_proj/kernel" in weights:
                put(f"{dst}/downsample/kernel", weights[f"{src}/conv_proj/kernel"])
                put(f"{dst}/gn_proj/weight", weights[f"{src}/gn_proj/scale"], (-1,))
                put(f"{dst}/gn_proj/bias", weights[f"{src}/gn_proj/bias"], (-1,))
    return params


def load_swinunet_pretrained(pretrained: Mapping, params: dict, depths=(2, 2, 2, 2)) -> dict:
    """A copy of SwinUnet's ``params`` tree with an upstream swin-tiny
    checkpoint loaded non-strictly: ``pretrained`` is the upstream dict
    (with its 'model' key, or unwrapped) of tensors or arrays; every
    encoder ``layers.{i}`` tensor also goes to the decoder's
    ``layers_up.{3-i}``; a tensor whose shape does not fit is skipped.
    Prints how many tensors loaded and how many were skipped."""
    if "model" in pretrained:
        pretrained = pretrained["model"]
    sd = {}
    for k, v in pretrained.items():
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        key = k if k.startswith("swin_unet.") else f"swin_unet.{k}"
        sd[key] = v
        if key.startswith("swin_unet.layers."):  # the encoder -> decoder mirror
            layer = 3 - int(key[len("swin_unet.layers.")])
            sd[f"swin_unet.layers_up.{layer}" + key[len("swin_unet.layers.0"):]] = v
    params = copy.deepcopy(params)
    loaded = skipped = 0
    for t_name, (path, kind) in swinunet_name_map(depths).items():
        if t_name not in sd:
            continue
        try:
            _put(params, path, _IN[kind](sd[t_name]))
        except ValueError:
            skipped += 1  # the reference deletes shape-mismatched keys (SwinUnet.py:1098-1100)
            continue
        loaded += 1
    print(f"load_swinunet_pretrained: loaded {loaded} tensors, skipped {skipped} shape "
          f"mismatches")
    return params
