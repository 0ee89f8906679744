"""Serve a nowcast: input frames in, predicted frames out.

    python -m adnm_tpu_torch.cli.predict --input frames.npy [--model NAME] [--dataset LAPS] [--ckpt PATH | --params params.npz] [--bf16] [--attn-type mla]

Reads (T_in, H, W) or (B, T_in, 1, H, W) frames in [0, 1] from .npy, runs
the forward of ``--model`` (default ADNMUnet, with ``--attn-type``; or the
baselines SmaATUnet, ConvLSTM, TrajGRU, LPTQPN, TransUnet and SwinUnet)
for the ``--dataset`` task (Shanghai: 5 frames in, 20 out; LAPS: 5 in, 3
out, and its own ADNMUnet configuration) in batches of
``--batch-size``, optionally chains it until
``--horizon`` frames exist, writes (B, T, 1, H, W) predictions to
``--output`` and, with ``--png DIR``, PNG strips per clip. Weights come
from ``--params`` (a JAX params tree saved by
``adnm_tpu_torch.convert.save_params_npz``; not for SmaATUnet or
TransUnet, whose running statistics it lacks), else from a checkpoint of
the port's train CLI (``--ckpt``, by default the model's best checkpoint
under ``--root``; BatchNorm's running statistics come with it), else,
with a warning, from the seeded init. A ConvLSTM, TransUnet or SwinUnet
serves only ``--img-size`` frames, the size its checkpoint was trained
at. ``--device`` defaults to cuda and raises when CUDA is absent.
``--bf16`` computes in bf16 from the fp32 weights, for every model.
On the card each forward is one CUDA graph replay (``forecast``), as JAX
jits it: the first batch of a shape runs eagerly and is captured.

``--mesh data=D[,seq=S][,model=M]`` (or ``--data-parallel``: one rank per
visible card) serves on D x S x M ranks of this host, one card each over
NCCL, or CPU ranks over gloo with ``--device cpu``: each 'data' position
runs its rows of every batch, the ADNM-UNet's frame rows are split in
bands over 'seq' (the other models run whole on every 'seq' rank), the
heads and hidden channels over 'model', the predictions are gathered in
order (the ``--horizon`` chain runs on the gathered frames, across the
ranks) and rank 0 writes ``--output`` and ``--png``. On a 'seq' or 'model'
axis larger than 1 the forwards run eagerly.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Union

import numpy as np
import torch

from adnm_tpu_torch.cli.common import (TASKS, add_mesh_args, compute_dtype, inference_launch,
                                       model_kwargs, resolve_ckpt, run_on_mesh)
from adnm_tpu_torch.convert import from_jax_params, load_params_npz, to_jax_batch_stats
from adnm_tpu_torch.core.layers import seeded_init_
from adnm_tpu_torch.device import resolve_device
from adnm_tpu_torch.models.registry import MODEL_NAMES, create_model
from adnm_tpu_torch.parallel.tensor import axis_size, data_rows, gather_data, use_mesh
from adnm_tpu_torch.train.checkpoint import load_model_state, restore_state
from adnm_tpu_torch.utils.graphs import GraphSet
from adnm_tpu_torch.viz import vis_res

INIT_SEED = 0  # weights without --params or a checkpoint


def load_model(params: Optional[str], device, ckpt: Optional[str] = None,
               compute_dtype: torch.dtype = torch.float32, model_name: str = "ADNMUnet",
               img_size: int = 256, dataset: str = "Shanghai",
               **model_kwargs) -> torch.nn.Module:
    """The model ``model_name`` in eval mode on ``device``
    (``resolve_device``: fp32 without TF32), with weights from the
    ``params`` .npz, else from the ``ckpt`` checkpoint file of the port's
    ``Trainer`` (its "params", BatchNorm's running statistics included),
    else from the init seeded with ``INIT_SEED``. ``img_size`` is the frame
    size, which fixes ConvLSTM's peephole weights, TransUnet's position
    embeddings and SwinUnet's windows (a checkpoint of another size
    raises). ``dataset`` is the task (``cli.common.TASKS``): its frame
    counts and interval, which pick the ADNMUnet configuration (LAPS's
    ``create_adnm_unet(5, 3, 60)``). ``model_kwargs`` go to the ADNMUnet
    factory, as the JAX
    registry passes them: ``linear_attn_duality=False`` builds the bimamba
    chunked-scan configuration, ``mixer_type="vssd"`` the VSSD mixer,
    ``attn_type="mla"`` MLA at the attention sites, ``simple_patch`` and
    ``compute_dead_features`` the factory's options; a checkpoint must come
    from the same configuration. The parameters are
    fp32 whatever ``compute_dtype`` ``forecast`` runs in; a model that
    cannot compute in ``compute_dtype`` raises here."""
    device = resolve_device(device)
    input_frames, output_frames, frame_interval, _ = TASKS[dataset]
    model = create_model(model_name, input_frames, output_frames, frame_interval,
                         img_size=img_size, **model_kwargs)
    check = getattr(model, "check_compute_dtype", None)
    if check is not None:
        check(compute_dtype)
    if params is not None:
        if to_jax_batch_stats(model):
            raise ValueError(f"{model_name} has BatchNorm running statistics, which a params "
                             f".npz does not carry: serve it from a --ckpt")
        from_jax_params(model, load_params_npz(params))
    elif ckpt is not None:
        load_model_state(model, restore_state(ckpt, {"params": {}})["params"], ckpt)
    else:
        seeded_init_(model, INIT_SEED)
    return model.to(device).eval()


def read_frames(path: str, img_size: int, input_frames: int = 5) -> np.ndarray:
    x = np.load(path).astype(np.float32)
    if x.ndim == 3:
        x = x[None, :, None]
    expected = (input_frames, 1, img_size, img_size)
    if x.ndim != 5 or x.shape[1:] != expected:
        raise ValueError(f"expected (B, {', '.join(map(str, expected))}) frames, got {x.shape}")
    return x


def forecast(model: torch.nn.Module, x: np.ndarray, batch_size: int, device: torch.device,
             horizon: Optional[int] = None, compute_dtype: torch.dtype = torch.float32,
             graphs: Union[GraphSet, bool, None] = None, mesh=None) -> np.ndarray:
    """Fp32 predictions for ``x`` (B, T_in, 1, H, W), the model run in eval
    mode on frames cast to ``compute_dtype``; with ``horizon`` beyond the
    model's T_out, the last T_in predicted frames (clipped to [0, 1] in
    fp32) are fed back until ``horizon`` frames exist. With graphs each
    forward is one CUDA graph replay, one graph per (batch shape, compute
    dtype); the first batch of a shape runs eagerly and is captured. The
    same bits either way. ``graphs``: the caller's ``GraphSet`` for this
    model, whose graphs serve its later calls too; True, a set for this
    call alone; False, eager; None (the default), True on a card and False
    elsewhere and on a 'seq' or 'model' axis larger than 1. On ``mesh``
    (``parallel.make_mesh``; every rank passes the same ``x``) each 'data'
    position runs its rows of every batch, under the 'seq' and 'model'
    axes (the ADNM-UNet's bands of rows and split heads; its prediction is
    gathered over 'seq' inside), and every rank gets every row's
    predictions."""
    model.eval()
    device = torch.device(device)
    split = axis_size(mesh, "model") > 1 or axis_size(mesh, "seq") > 1
    if graphs is None:
        graphs = device.type == "cuda" and not split
    if graphs is not False and (device.type != "cuda" or split):
        raise ValueError(f"graphs needs a CUDA device, not {device}, and 'seq' and 'model' "
                         f"axes of 1")
    graph_set = None if graphs is False else GraphSet(device) if graphs is True else graphs

    def run(xb: torch.Tensor) -> torch.Tensor:
        if graph_set is None:
            return model(xb).float()
        return graph_set.run(("forward", tuple(xb.shape), xb.dtype), lambda v: model(v).float(),
                             (xb,), binding=lambda: [*model.parameters(), *model.buffers()],
                             label=f"{type(model).__name__} forward of {tuple(xb.shape)} "
                                   f"{xb.dtype}")

    def forward(inp: np.ndarray) -> np.ndarray:
        outs = []
        with torch.inference_mode(), use_mesh(mesh):
            for i in range(0, inp.shape[0], batch_size):
                batch = inp[i:i + batch_size]
                rows = batch[data_rows(mesh, batch.shape[0])]
                out = None
                if rows.shape[0]:
                    out = run(torch.from_numpy(np.ascontiguousarray(rows)).to(device,
                                                                              compute_dtype))
                outs.append(gather_data(mesh, out, batch.shape[0]).cpu().numpy())
        return np.concatenate(outs)

    preds = forward(x)
    if horizon and horizon > preds.shape[1]:
        chunks, total, cur = [preds], preds.shape[1], preds
        while total < horizon:
            cur = forward(np.clip(cur[:, -x.shape[1]:], 0.0, 1.0))
            chunks.append(cur)
            total += cur.shape[1]
        preds = np.concatenate(chunks, axis=1)[:, :horizon]
    return preds


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("adnm-torch-predict")
    p.add_argument("--input", required=True, help=".npy input frames")
    p.add_argument("--model", default="ADNMUnet", choices=list(MODEL_NAMES))
    p.add_argument("--dataset", default="Shanghai", choices=list(TASKS),
                   help="the task the weights were trained for: Shanghai (5 -> 20 frames) "
                        "or LAPS (5 -> 3 frames)")
    p.add_argument("--attn-type", default="standard", choices=["standard", "mla"],
                   help="ADNMUnet only: mixer at the AttentionBlock sites (standard softmax "
                        "attention or DeepSeek-V2 MLA); a checkpoint must have the same")
    p.add_argument("--output", default="prediction.npy")
    p.add_argument("--params", default=None,
                   help=".npz of the JAX params tree (adnm_tpu_torch.convert.save_params_npz)")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint of the port's train CLI (default: the model's best under "
                        "--root); "
                        f"without it or --params the weights come from the init seeded with "
                        f"{INIT_SEED}")
    p.add_argument("--root", default=os.environ.get("ADNM_ROOT", "runs"),
                   help="output root of the train CLI, where the best checkpoint is looked for")
    p.add_argument("--png", default=None, help="optional dir for rendered strips")
    p.add_argument("--horizon", type=int, default=None,
                   help="chained rollout: keep feeding the last T_in predicted frames back "
                        "until >= horizon frames are produced")
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute for any model (fp32 params; the predictions are "
                        "written in fp32)")
    add_mesh_args(p)
    return p


def main(argv=None) -> np.ndarray:
    args = make_parser().parse_args(argv)
    launch = inference_launch(args, "predict")
    return run(args) if launch is None else run_on_mesh(run, args, launch)


def run(args, mesh=None, device=None) -> np.ndarray:
    """Serve in this process, one rank of ``mesh`` where given; rank 0 writes
    the outputs. Returns the predictions."""
    cdt = compute_dtype(args)
    device = resolve_device(args.device) if device is None else device
    lead = mesh is None or mesh.get_rank() == 0
    x = read_frames(args.input, args.img_size, TASKS[args.dataset][0])
    ckpt = None if args.params is not None else resolve_ckpt(
        args.ckpt, args.root, "warning: no checkpoint at {}; predicting with fresh init",
        args.dataset, args.model)
    model = load_model(args.params, device, ckpt=ckpt, compute_dtype=cdt, model_name=args.model,
                       img_size=args.img_size, dataset=args.dataset, **model_kwargs(args))
    if ckpt is not None and lead:
        print(f"loaded checkpoint: {ckpt}")
    preds = forecast(model, x, args.batch_size, device, args.horizon, cdt, mesh=mesh)
    if lead:
        np.save(args.output, preds)
        print(f"wrote {args.output} {preds.shape}")
        if args.png:
            for b in range(preds.shape[0]):
                vis_res(preds[b, :, 0], input_seq=x[b, :, 0],
                        save_path=os.path.join(args.png, f"sample{b}"), pic_name="pred")
            print(f"rendered strips under {args.png}")
    return preds


if __name__ == "__main__":
    main()
