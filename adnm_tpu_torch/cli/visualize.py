"""Render prediction strips of a trained model (``--model``) (counterpart of
adnm_tpu/cli/visualize.py; reference: pic_results.py main loop
:236-275).

    python -m adnm_tpu_torch.cli.visualize --synthetic --ckpt PATH [--dataset LAPS] [--device cpu] [--bf16]

Loads a checkpoint (``--ckpt``, else the best under ``--root``), runs the
test split and writes pred/gt/input PNG strips for up to
``--max-samples`` clips under ``--out`` (default
{root}/result_pics2/{dataset}), one directory per clip. Shanghai's
20-frame strips keep every second frame, as in the reference; LAPS's
3-frame strips keep every frame.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from adnm_tpu_torch.cli.common import add_common_args, build, resolve_ckpt, single_card
from adnm_tpu_torch.viz import vis_res


def main(argv=None) -> list:
    """Returns the sample directories written."""
    p = argparse.ArgumentParser("adnm-torch-visualize")
    add_common_args(p)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--out", default=None, help="output dir (default {root}/result_pics2/{dataset})")
    p.add_argument("--max-samples", type=int, default=8)
    args = p.parse_args(argv)

    single_card(args, "visualize")
    trainer, (_, _, test_loader), (ti, _, _, _) = build(args)
    ckpt_path = resolve_ckpt(args.ckpt, args.root,
                             "checkpoint not found ({}); rendering fresh init",
                             args.dataset, args.model)
    if ckpt_path:
        trainer.load(ckpt_path)
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
            vis_res(preds[b, :, 0], gt_seq=batch[b, ti:, 0], input_seq=batch[b, :ti, 0],
                    save_path=sample_dir, pic_name=args.model, even_index_only=even)
            written.append(sample_dir)
            print(f"wrote {sample_dir}")
    return written


if __name__ == "__main__":
    main()
