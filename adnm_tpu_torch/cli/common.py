"""Shared CLI plumbing of the port (counterpart of adnm_tpu/cli/common.py):
flags, the task shape, and the Trainer and loaders they build."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from adnm_tpu_torch.convert import from_jax_params, to_jax_params
from adnm_tpu_torch.data.laps import LAPS_THRESHOLDS, make_laps_datasets
from adnm_tpu_torch.data.loader import BatchLoader
from adnm_tpu_torch.data.shanghai import make_datasets
from adnm_tpu_torch.device import resolve_device
from adnm_tpu_torch.models.adnm_unet import apply_reference_init
from adnm_tpu_torch.models.registry import MODEL_NAMES, create_model
from adnm_tpu_torch.train.checkpoint import best_ckpt_dir
from adnm_tpu_torch.train.loop import Trainer
from adnm_tpu_torch.train.presets import get_preset


def add_common_args(p: argparse.ArgumentParser):
    p.add_argument("--model", default="ADNMUnet", choices=list(MODEL_NAMES))
    p.add_argument("--dataset", default="Shanghai", choices=["Shanghai", "LAPS"],
                   help="the task: Shanghai (5 -> 20 frames, 6-minute interval) or LAPS "
                        "(5 -> 3 frames, 60-minute interval, its own ADNMUnet configuration)")
    p.add_argument("--data-path", default=os.environ.get("ADNM_DATA", "datasets/shanghai.h5"))
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic dataset (no h5 needed)")
    p.add_argument("--synthetic-len", type=int, default=64)
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--root", default=os.environ.get("ADNM_ROOT", "runs"),
                   help="output root for model_params/ and results/ (reference: config.py:5)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the whole training forward in the backward "
                        "(torch.utils.checkpoint): less activation memory, more "
                        "step time, the same gradients. Ignored for BatchNorm models "
                        "(SmaATUnet)")
    p.add_argument("--no-refiner-remat", action="store_true",
                   help="ADNMUnet only: keep the refiner Blocks' activations instead of "
                        "recomputing their forward in the backward: faster step, more memory")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (fp32 params/optimizer - mixed precision; the loss "
                        "is computed in fp32) for every model, with the JAX model's dtype at "
                        "each layer (the baselines turn fp32 where JAX promotes)")
    p.add_argument("--attn-type", default="standard", choices=["standard", "mla"],
                   help="ADNMUnet only: mixer at the AttentionBlock sites (standard softmax "
                        "attention or DeepSeek-V2 MLA)")
    p.add_argument("--transfer-dtype", default="float32", choices=["float32", "uint8"],
                   help="batch wire format host->device; uint8 ships round(x*255) "
                        "and normalizes on the device (4x fewer bytes)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pretrained-npz", default=None,
                   help="TransUnet only: load the encoder from a google-ViT R50+ViT-B/16 .npz "
                        "(train.npz_import.load_transunet_npz)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises when CUDA is absent) or cpu")


TASKS = {
    "Shanghai": (5, 20, 6, (20, 30, 35, 40)),
    "LAPS": (5, 3, 60, LAPS_THRESHOLDS),
}


def task_shape(args):
    """(input_frames, output_frames, frame_interval, thresholds) of
    ``args.dataset`` (reference: train.py:40-66; JAX:
    adnm_tpu/cli/common.py:91-96)."""
    return TASKS[args.dataset]


def resolve_ckpt(ckpt, root: str, missing: str, dataset: str = "Shanghai",
                 model: str = "ADNMUnet"):
    """The checkpoint an entry point loads: ``ckpt``, else the best under
    ``root`` (reference: config.py:8). Where that file does not exist,
    prints ``missing`` with the path in its ``{}`` and returns None: the
    caller keeps the fresh init."""
    path = ckpt or best_ckpt_dir(root, dataset, model)
    if os.path.exists(path):
        return path
    print(missing.format(path))
    return None


def compute_dtype(args) -> torch.dtype:
    """The activations' dtype of ``--bf16``."""
    return torch.bfloat16 if getattr(args, "bf16", False) else torch.float32


def model_kwargs(args) -> dict:
    """The ADNMUnet options of ``args`` for ``create_model``; with another
    model they exit, as in JAX (adnm_tpu/cli/common.py:173-178)."""
    kwargs = {}
    if getattr(args, "no_refiner_remat", False):
        if args.model != "ADNMUnet":
            raise SystemExit("--no-refiner-remat is only supported for --model ADNMUnet")
        kwargs["refiner_remat"] = False
    if args.attn_type != "standard":
        if args.model != "ADNMUnet":
            raise SystemExit("--attn-type is only supported for --model ADNMUnet")
        kwargs["attn_type"] = args.attn_type
    return kwargs


def load_pretrained_npz(model: torch.nn.Module, path: str) -> None:
    """``--pretrained-npz``: the encoder of the TransUnet ``model`` from the
    .npz at ``path`` (JAX: adnm_tpu/cli/common.py:205-215)."""
    from adnm_tpu_torch.train.npz_import import load_transunet_npz

    with np.load(path) as npz:
        tree = load_transunet_npz(npz, to_jax_params(model), model.hybrid_model.block_units,
                                  model.num_layers)
    from_jax_params(model, tree)
    print(f"loaded pretrained encoder from {path}")


def build(args):
    """(Trainer, (train, val, test) loaders, (input_frames, output_frames,
    frame_interval, thresholds)): ``args.model`` from the port's registry
    with its preset; the reference init for ADNMUnet alone; TransUnet's
    encoder from ``--pretrained-npz`` where given."""
    kwargs = model_kwargs(args)
    if args.pretrained_npz and args.model != "TransUnet":
        raise SystemExit("--pretrained-npz is only supported for --model TransUnet")
    shape = task_shape(args)
    input_frames, output_frames, frame_interval, _ = shape
    device = resolve_device(args.device)
    accum = getattr(args, "accum_steps", 1) or 1
    if args.batch_size % accum:
        raise SystemExit(f"--accum-steps {accum} must divide --batch-size {args.batch_size}")
    model = create_model(args.model, input_frames, output_frames, frame_interval,
                         img_size=args.img_size, **kwargs)
    preset = get_preset(args.model, input_frames, output_frames, frame_interval, args.dataset)
    trainer = Trainer(model, preset, input_frames, device, seed=args.seed,
                      param_transform=apply_reference_init if args.model == "ADNMUnet" else None,
                      remat_forward=args.remat, accum_steps=accum,
                      compute_dtype=compute_dtype(args))
    if args.pretrained_npz:
        load_pretrained_npz(trainer.model, args.pretrained_npz)
    data_path = None if args.synthetic else args.data_path
    make = make_laps_datasets if args.dataset == "LAPS" else make_datasets
    tr, va, te = make(data_path, args.img_size, synthetic_len=args.synthetic_len)
    tdt = args.transfer_dtype
    return trainer, (
        BatchLoader(tr, args.batch_size, shuffle=True, seed=args.seed, transfer_dtype=tdt),
        BatchLoader(va, args.batch_size, drop_last=False, transfer_dtype=tdt),
        BatchLoader(te, args.batch_size, drop_last=False, transfer_dtype=tdt),
    ), shape
