"""Train-state checkpoints with ``torch.save`` (counterpart of
adnm_tpu/train/checkpoint.py; reference: torch.save of a state_dict,
train.py:169-178,209-213).

A checkpoint is one file holding a flat dict ``{"params", "opt_state",
"step"}``: the model's and the optimizer's state dicts and the step
count. Restoring keeps the target's value for any key the file lacks, as
the JAX package does, so the layout can grow. The path scheme mirrors the
reference: {root}/model_params/{dataset}/{model}/{model}_best. Orbax
checkpoints of the JAX package are not read.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict

import torch


def best_ckpt_dir(root: str, dataset: str, model_name: str) -> str:
    return os.path.join(root, "model_params", dataset, model_name, f"{model_name}_best")


def save_state(path: str, state: Dict[str, Any]) -> None:
    """Write ``state`` to ``path``; a reader never sees half a file."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # torch.save names the archive's root folder after the file's stem,
    # which must not be empty: no leading dot
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=os.path.basename(path) + "-",
                               suffix=".tmp")
    os.close(fd)
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_model_state(model: torch.nn.Module, params: Dict[str, Any], path: str) -> None:
    """``model.load_state_dict(params)`` (parameters and buffers, BatchNorm's
    running statistics among them), after a check that names the entries
    whose shapes do not fit (a RuntimeError, as ``load_state_dict``'s): a
    ConvLSTM, TransUnet or SwinUnet checkpoint, whose peephole weights,
    position embeddings or window tables are shaped by the frame size,
    serves only the ``--img-size`` it was trained at."""
    want = model.state_dict()
    bad = [f"{k} {tuple(v.shape)} (model {tuple(want[k].shape)})" for k, v in params.items()
           if k in want and v.shape != want[k].shape]
    if bad:
        raise RuntimeError(f"checkpoint {path} does not fit the state_dict of the model built "
                           f"here: {bad[:4]}; a ConvLSTM, TransUnet or SwinUnet checkpoint "
                           f"serves only the --img-size it was trained at")
    model.load_state_dict(params)


def restore_state(path: str, target: Dict[str, Any]) -> Dict[str, Any]:
    """``target`` with every key the file at ``path`` holds replaced by the
    file's value. The tensors come back on the CPU."""
    restored = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return {**target, **{k: v for k, v in restored.items() if k in target}}
