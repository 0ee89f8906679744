"""Convert a reference torch checkpoint ({model}_best.pth, reference
train.py:174) into a checkpoint of the PyTorch port, which its validate,
visualize and predict CLIs load.

    python scripts/torch_convert_reference_ckpt.py --model SmaATUnet \
        --pth /path/to/SmaATUnet_best.pth --out runs \
        [--dataset Shanghai] [--input-frames 5] [--output-frames 20] [--img-size 256]

Reads the file with ``torch.load(weights_only=True)`` (a state_dict of
tensors; a pickled module object is refused with the reason), maps it
onto the port's model of ``--model`` (any of the seven) through
``adnm_tpu_torch.train.adnm_import.convert_adnm_state_dict`` (ADNMUnet)
or ``adnm_tpu_torch.train.torch_import`` (the baselines), checks every
parameter and running statistic of the freshly built model against the
converted ones, naming the missing and the mismatched, and writes
{out}/model_params/{dataset}/{model}/{model}_best (the train CLI's best
checkpoint): the imported weights, a fresh optimizer state, step 0. Runs
on the CPU.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODELS = ("ADNMUnet", "SmaATUnet", "ConvLSTM", "TrajGRU", "LPTQPN", "TransUnet", "SwinUnet")


def read_state_dict(path: str) -> dict:
    """The reference's state_dict, loaded without unpickling objects."""
    import torch

    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise SystemExit(f"{path} holds pickled objects other than tensors (a whole nn.Module, "
                         f"saved with torch.save(model)?), which weights_only loading refuses: "
                         f"save its state_dict() instead ({str(e).splitlines()[0]})") from e
    if not isinstance(sd, dict) or not all(isinstance(v, torch.Tensor) for v in sd.values()):
        raise SystemExit(f"{path} does not hold a state_dict of tensors")
    return sd


def reference_trees(model_name: str, model, sd: dict, **adnm_cfg):
    """The JAX-layout (params, batch_stats) trees of ``sd`` for ``model``."""
    from adnm_tpu_torch.train import torch_import

    if model_name == "ADNMUnet":
        from adnm_tpu_torch.train.adnm_import import convert_adnm_state_dict

        return convert_adnm_state_dict(sd, **adnm_cfg), {}
    if model_name == "ConvLSTM":
        params, _ = torch_import.convert_state_dict(sd, torch_import.convlstm_name_map(),
                                                    optional=("peephole",))
        torch_import._zero_peepholes(params, model)
        return params, {}
    if model_name == "TrajGRU":
        return torch_import.convert_state_dict(sd, torch_import.trajgru_name_map())
    if model_name == "LPTQPN":
        return torch_import.convert_state_dict(sd, torch_import.lptqpn_name_map())
    return torch_import.convert_state_dict(sd, torch_import.reference_name_map(model_name, model))


def check_trees(model, params: dict, stats: dict) -> None:
    """Every parameter and running statistic of ``model`` against the
    converted trees: prints up to 10 missing and 10 mismatched, then exits."""
    from adnm_tpu_torch.convert import flatten_tree, to_jax_batch_stats, to_jax_params

    want = {**flatten_tree(to_jax_params(model)), **flatten_tree(to_jax_batch_stats(model))}
    got = {**flatten_tree(params), **flatten_tree(stats)}
    missing = [k for k in want if k not in got]
    mismatched = [(k, got[k].shape, want[k].shape) for k in want
                  if k in got and got[k].shape != want[k].shape]
    if missing or mismatched:
        for k in missing[:10]:
            print("missing:", k)
        for k in mismatched[:10]:
            print("shape mismatch:", k)
        raise SystemExit(f"conversion incomplete: {len(missing)} missing, "
                         f"{len(mismatched)} mismatched")


def convert_checkpoint(model_name: str, sd: dict, out: str, dataset: str = "Shanghai",
                       input_frames: int = 5, output_frames: int = 20, img_size: int = 256,
                       model=None, **adnm_cfg) -> str:
    """Import ``sd`` into ``model`` (by default the registry's
    ``model_name``; ``adnm_cfg`` goes to the ADNM-UNet's name map) and write
    the port's best checkpoint under ``out``; returns its path."""
    import torch

    from adnm_tpu_torch.convert import from_jax_params
    from adnm_tpu_torch.models.registry import create_model
    from adnm_tpu_torch.train.checkpoint import best_ckpt_dir, save_state
    from adnm_tpu_torch.train.loop import Trainer
    from adnm_tpu_torch.train.presets import get_preset

    frame_interval = 6 if dataset == "Shanghai" else 60
    if model is None:
        model = create_model(model_name, input_frames, output_frames, frame_interval,
                             img_size=img_size)
    if model_name == "ADNMUnet":  # as create_adnm_unet chooses the norm
        adnm_cfg.setdefault("instance_norm", frame_interval < 120 / input_frames)
    preset = get_preset(model_name, input_frames, output_frames, frame_interval, dataset)
    trainer = Trainer(model, preset, input_frames, torch.device("cpu"))
    params, stats = reference_trees(model_name, model, sd, **adnm_cfg)
    check_trees(model, params, stats)
    from_jax_params(model, params, stats or None)
    path = best_ckpt_dir(out, dataset, model_name)
    save_state(path, trainer.state_dict())
    print(f"wrote {path}")
    return path


def main(argv=None) -> str:
    p = argparse.ArgumentParser("torch-convert-reference-ckpt")
    p.add_argument("--model", required=True, choices=MODELS)
    p.add_argument("--pth", required=True, help="the reference's {model}_best.pth")
    p.add_argument("--out", default="runs", help="the port's output root (the CLIs' --root)")
    p.add_argument("--dataset", default="Shanghai")
    p.add_argument("--input-frames", type=int, default=5)
    p.add_argument("--output-frames", type=int, default=20)
    p.add_argument("--img-size", type=int, default=256)
    args = p.parse_args(argv)
    return convert_checkpoint(args.model, read_state_dict(args.pth), args.out, args.dataset,
                              args.input_frames, args.output_frames, args.img_size)


if __name__ == "__main__":
    main()
