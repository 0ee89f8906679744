"""How far a training step's gradients in bf16 compute lie from fp32, in
the JAX package and in the port, on the CPU, for a narrow ADNM-UNet at a
large frame size: whether the port's bf16 backward loses more than JAX's.

    python3 scripts/torch_bf16_grad_vs_jax.py [--img-size 256]

The TINY widths of ``tests/test_train_modes.py`` (embed 8, 5 -> 2 frames,
kernel 3), the standard and the MLA attention, one batch-1 synthetic clip,
the same numpy-drawn weights in both packages (``convert.from_jax_params``):
the relative L2 distance of all bf16 gradients from the fp32 ones, JAX's
and the port's, and the port's fp32 and bf16 gradients against JAX's.
JAX runs on the CPU; the port on the CPU through the kernels' plain
versions.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def main() -> None:
    p = argparse.ArgumentParser("torch_bf16_grad_vs_jax")
    p.add_argument("--img-size", type=int, default=256)
    size = p.parse_args().img_size

    import jax
    import jax.numpy as jnp
    import torch

    from adnm_tpu.models import adnm_unet as jmodel
    from adnm_tpu.train import get_preset as jget_preset
    from adnm_tpu_torch import convert
    from adnm_tpu_torch.models import adnm_unet as model
    from adnm_tpu_torch.train.loop import Trainer
    from adnm_tpu_torch.train.presets import get_preset
    from test_torch_port_layers import random_params
    from test_train_modes import TINY, _batches

    torch.set_num_threads(4)
    kw = dict(channels=5, out_channels=2, kernel=(3, 3, 3), **TINY)
    (batch,) = _batches(1, 1, size=size)
    preset = jget_preset("ADNMUnet", 5, 2, 6, "Shanghai")

    def flat(tree) -> np.ndarray:
        f = convert.flatten_tree(tree)
        return np.concatenate([np.asarray(f[k], np.float64).ravel() for k in sorted(f)])

    def rel(a, b) -> float:
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for attn in ("standard", "mla"):
        jm = jmodel.ADNMUNet(**kw, attn_type=attn)
        params = random_params(jm, jnp.zeros((1, 5, 1, size, size)), train=True)

        def loss_fn(p, dtype):
            out = jm.apply({"params": p}, jnp.asarray(batch[:, :5]).astype(dtype), train=True)
            return preset.loss_fn(out.astype(jnp.float32), jnp.asarray(batch[:, 5:]))

        grad = jax.jit(jax.grad(loss_fn), static_argnums=1)
        jg = {dt: flat(jax.device_get(grad(jax.tree.map(jnp.asarray, params), dt)))
              for dt in (jnp.float32, jnp.bfloat16)}
        t = Trainer(model.ADNMUNet(**kw, attn_type=attn), get_preset("ADNMUnet", 5, 2, 6,
                                                                      "Shanghai"),
                    5, torch.device("cpu"), seed=0)
        convert.from_jax_params(t.model, params)
        pg = {}
        for dt in (torch.float32, torch.bfloat16):
            t.compute_dtype = dt  # read by _split_batch alone
            pg[dt] = flat(convert.to_jax_params(t.model, t.grads(batch)[1]))
        print(f"{attn} {size}^2: bf16 vs fp32 gradients, rel L2: JAX "
              f"{rel(jg[jnp.bfloat16], jg[jnp.float32]):.3e}, port "
              f"{rel(pg[torch.bfloat16], pg[torch.float32]):.3e}; port vs JAX: fp32 "
              f"{rel(pg[torch.float32], jg[jnp.float32]):.3e}, bf16 "
              f"{rel(pg[torch.bfloat16], jg[jnp.bfloat16]):.3e}")


if __name__ == "__main__":
    main()
