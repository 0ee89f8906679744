"""Render prediction strips of a trained model (``--model``) (counterpart of
adnm_tpu/cli/visualize.py; reference: pic_results.py main loop
:236-275).

    python -m adnm_tpu_torch.cli.visualize --synthetic --ckpt PATH [--dataset LAPS] [--device cpu] [--bf16]

Loads a checkpoint (``--ckpt``, else the best under ``--root``), runs the
test split and writes pred/gt/input PNG strips for up to
``--max-samples`` clips under ``--out`` (default
{root}/result_pics2/{dataset}), one directory per clip. Shanghai's
20-frame strips keep every second frame, as in the reference; LAPS's
3-frame strips keep every frame. With ``--mesh`` or ``--data-parallel``
(as validate) the ranks predict their rows of each batch and rank 0
writes the strips.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from adnm_tpu_torch.cli.common import (add_common_args, build, inference_launch, resolve_ckpt,
                                       run_on_mesh)
from adnm_tpu_torch.viz import vis_res


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("adnm-torch-visualize")
    add_common_args(p)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--out", default=None, help="output dir (default {root}/result_pics2/{dataset})")
    p.add_argument("--max-samples", type=int, default=8)
    return p


def main(argv=None) -> list:
    """Returns the sample directories written (rank 0's, on a mesh)."""
    args = make_parser().parse_args(argv)
    launch = inference_launch(args, "visualize")
    if launch is None:
        return run(args)["written"]
    return run_on_mesh(run, args, launch)["written"]


def run(args, mesh=None, device=None) -> dict:
    """Render in this process, one rank of ``mesh`` where given: every rank
    predicts its rows of each batch, rank 0 writes the strips."""
    trainer, (_, _, test_loader), (ti, _, _, _) = build(args, device=device, mesh=mesh)
    lead = trainer.rank == 0
    ckpt_path = resolve_ckpt(args.ckpt, args.root,
                             "checkpoint not found ({}); rendering fresh init",
                             args.dataset, args.model)
    if ckpt_path:
        trainer.load(ckpt_path)
        if lead:
            print(f"loaded checkpoint: {ckpt_path}")
    out_root = args.out or os.path.join(args.root, "result_pics2", args.dataset)
    even = args.dataset == "Shanghai"  # 20-frame outputs get the even-index subsample

    written = []
    for batch in test_loader:
        if len(written) >= args.max_samples:
            break
        _, preds = trainer.predict(batch)
        preds = preds.cpu().numpy()
        if np.issubdtype(batch.dtype, np.integer):  # the uint8 wire: back to [0, 1]
            batch = batch.astype(np.float32) / 255.0
        for b in range(preds.shape[0]):
            if len(written) >= args.max_samples:
                break
            sample_dir = os.path.join(out_root, args.model, f"sample{len(written)}")
            if lead:
                vis_res(preds[b, :, 0], gt_seq=batch[b, ti:, 0], input_seq=batch[b, :ti, 0],
                        save_path=sample_dir, pic_name=args.model, even_index_only=even)
                print(f"wrote {sample_dir}")
            written.append(sample_dir)
    return {"written": written, "trainer": trainer}


if __name__ == "__main__":
    main()
