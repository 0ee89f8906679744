"""The training loop (counterpart of adnm_tpu/train/loop.py; reference:
train.py:107-250), on one device.

One step per batch: forward, loss, backward (with gradient accumulation
over ``accum_steps`` microbatches), the global fp32 gradient norm, the
preset's clip (ADNMUnet's adaptive one; the baselines do not clip), the
epoch's LR and the preset's optimizer step (AdamW, Adam or SGD). With
``compute_dtype`` bfloat16 (the JAX package's ``--bf16``) the activations
run in bf16 while the parameters, their gradients and the optimizer state
stay fp32, and the loss is computed in fp32. The model is in train mode
for a step and in eval mode for evaluation, so BatchNorm normalises with
the batch's statistics and advances its running statistics (once per
microbatch) in a step, and uses the running statistics in evaluation.
Dropout and DropPath (TransUnet, SwinUnet) draw their masks from the
trainer's own generator on the device, seeded from (seed, step,
microbatch) at the start of each training forward, so a step is a function
of the state and the step number; under whole-forward remat the recompute
re-seeds it and draws the same masks. The backward runs with cuDNN held to its
deterministic algorithms, so two steps of one batch give the same bits on
the card. LR and clip threshold are
host-side scalars set per epoch, as in the reference's per-epoch Python
schedules (train.py:122-130,186-191). Losses and gradient norms stay on
the device until the epoch ends, so the host never waits for a step.

As in the JAX package, validation consumes the val batches (the
reference re-evaluates the last training batch, train.py:159-160).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from adnm_tpu_torch.core.layers import seeded_init_
from adnm_tpu_torch.core.stochastic import attach_generator, step_seed
from adnm_tpu_torch.data.loader import device_prefetch, to_device
from adnm_tpu_torch.device import deterministic_cudnn
from adnm_tpu_torch.train import checkpoint as ckpt
from adnm_tpu_torch.train.presets import TrainPreset
from adnm_tpu_torch.utils.logging import MetricsLogger


@dataclasses.dataclass
class EpochLog:
    epoch: int
    train_loss: float
    val_loss: float
    test_loss: float
    lr: float
    grad_norm_avg: float
    clip_threshold: float
    clip_ratio: float
    seconds: float


class Trainer:
    def __init__(self, model: nn.Module, preset: TrainPreset, input_frames: int,
                 device: torch.device, seed: int = 0,
                 param_transform: Optional[Callable[[nn.Module, torch.Generator], nn.Module]] = None,
                 remat_forward: bool = False, accum_steps: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        """The model's weights come from the init seeded with ``seed``
        (``seeded_init_``, on the CPU), then ``param_transform(model,
        generator seeded with seed + 1)`` (``apply_reference_init`` for
        ADNMUnet); then the model moves to ``device``.

        ``remat_forward=True`` runs the whole training forward under
        ``torch.utils.checkpoint``: the backward recomputes it instead of
        keeping activations; the gradients are the same. Ignored for a
        model with BatchNorm, as in JAX: the recompute would advance its
        running statistics a second time.

        ``accum_steps=m`` (m > 1) splits each batch into m equal
        microbatches, runs them one after another and averages their
        gradients before one optimizer step: activation memory drops about
        m-fold. Exact for the reference losses, which are elementwise
        means. Needs batch % accum_steps == 0.

        ``compute_dtype`` is the activations' dtype (float32, or bfloat16
        as the JAX ``--bf16``); a model configuration that cannot compute in
        it (``check_compute_dtype``) raises here, before any work."""
        if accum_steps < 1:
            raise ValueError("accum_steps must be >= 1")
        check = getattr(model, "check_compute_dtype", None)
        if check is not None:
            check(compute_dtype)
        self.compute_dtype = compute_dtype
        self.model = model
        self.preset = preset
        self.input_frames = input_frames
        self.device = device
        self.has_batch_stats = any(getattr(m, "batch_stats", ()) for m in model.modules())
        self.remat_forward = remat_forward and not self.has_batch_stats
        self.accum_steps = int(accum_steps)
        seeded_init_(model, seed)
        if param_transform is not None:
            param_transform(model, torch.Generator().manual_seed(seed + 1))
        model.to(device)
        self.seed = seed
        self.generator = torch.Generator(device=device)  # Dropout and DropPath masks
        attach_generator(model, self.generator)
        self.params = list(model.parameters())
        self.optimizer = preset.make_optimizer(self.params)
        self.step = 0

    # ---- one batch ----------------------------------------------------

    def _split_batch(self, batch: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(imgs, targets) from a (B, T_in+T_out, 1, S, S) batch, in one of
        two wire formats: float (already in [0, 1]) or uint8 (round(x*255),
        brought back to [0, 1] on the device). The images come in the
        compute dtype, the targets in fp32, with JAX's arithmetic: uint8
        images are cast and then multiplied by 1/255 rounded to the compute
        dtype."""
        t, cdt = self.input_frames, self.compute_dtype
        if batch.is_floating_point():
            return batch[:, :t].to(cdt), batch[:, t:]
        scale = float(torch.tensor(1.0 / 255.0, dtype=cdt))  # 1/255 in cdt
        return batch[:, :t].to(cdt) * scale, batch[:, t:].to(torch.float32) * (1.0 / 255.0)

    def _forward(self, imgs: torch.Tensor, micro: int = 0) -> torch.Tensor:
        """The training forward of microbatch ``micro`` of this step, its
        masks drawn from the generator seeded at its start (again in the
        remat's recompute)."""
        seed = step_seed(self.seed, self.step, micro)

        def run(x):
            self.generator.manual_seed(seed)
            return self.model(x)

        if self.remat_forward and torch.is_grad_enabled():
            return checkpoint(run, imgs, use_reentrant=False)
        return run(imgs)

    def _backward(self, batch: torch.Tensor) -> torch.Tensor:
        """The batch's loss, with its gradients in the parameters' ``grad``
        (the mean over the microbatches). A parameter the loss does not
        reach gets a zero gradient, as in JAX, so AdamW still decays it.
        Runs the model in train mode."""
        self.model.train()
        imgs, targets = self._split_batch(batch)
        m = self.accum_steps
        if imgs.shape[0] % m:
            raise ValueError(f"batch {imgs.shape[0]} not divisible by accum_steps {m}")
        for p in self.params:
            p.grad = None
        loss = torch.zeros((), device=imgs.device)
        for i, (im, tg) in enumerate(zip(imgs.chunk(m), targets.chunk(m))):
            part = self.preset.loss_fn(self._forward(im, i).float(), tg)
            with deterministic_cudnn():  # the convolutions' dgrad and wgrad
                part.backward()
            loss = loss + part.detach()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif m > 1:
                p.grad.div_(m)
        return loss / m

    def grads(self, batch: np.ndarray) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {parameter name: gradient}) of one host batch, with no
        optimizer step."""
        loss = self._backward(to_device(batch, self.device))
        return loss, {name: p.grad for name, p in self.model.named_parameters()}

    def train_step(self, batch: torch.Tensor, lr: float,
                   clip_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, global gradient norm) on the device, after one step: under
        the preset's ``norm_clip`` the gradients scaled by min(1, clip_norm
        / (norm + 1e-6)), then the optimizer at ``lr``. Without it the
        gradients are not scaled (the norm is still computed, for the
        log)."""
        loss = self._backward(batch)
        # the same scale: clip_grad_norm_ multiplies by clamp(max_norm /
        # (norm + 1e-6), max=1), which is exactly 1 at max_norm = inf
        max_norm = clip_norm if self.preset.norm_clip else float("inf")
        gnorm = nn.utils.clip_grad_norm_(self.params, max_norm)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return loss, gnorm

    @torch.no_grad()
    def eval_step(self, batch: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, predictions) in eval mode."""
        self.model.eval()
        imgs, targets = self._split_batch(batch)
        out = self.model(imgs).float()
        return self.preset.loss_fn(out, targets), out

    # ---- loops ----------------------------------------------------------

    def train_epoch(self, loader, lr: float, clip_norm: float) -> Dict[str, float]:
        losses, gnorms = [], []
        for batch in device_prefetch(loader, self.device):
            loss, gnorm = self.train_step(batch, lr, clip_norm)
            losses.append(loss)
            gnorms.append(gnorm)
        losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
        gnorms = torch.stack(gnorms).cpu().numpy() if gnorms else np.zeros(0, np.float32)
        n = int(losses.size)
        clip_count = int(np.sum(gnorms > clip_norm)) if self.preset.norm_clip else 0
        return {
            "loss": float(losses.sum()),
            "avg_grad_norm": float(gnorms.mean()) if n else 0.0,
            "clip_ratio": clip_count / max(n, 1),
            "steps": n,
        }

    def predict(self, batch: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, predictions) for one host batch."""
        return self.eval_step(to_device(batch, self.device))

    def eval_epoch(self, loader, collect: bool = False):
        """(summed loss, predictions, ground truths); the last two are None
        unless ``collect``, else (N, T_out, S, S) fp32 arrays, the ground
        truths in [0, 1]."""
        losses, preds, gts = [], [], []
        for batch in device_prefetch(loader, self.device):
            loss, out = self.eval_step(batch)
            losses.append(loss)
            if collect:
                preds.append(out[:, :, 0].cpu().numpy())
                g = batch[:, self.input_frames:, 0].cpu().numpy()
                if np.issubdtype(g.dtype, np.integer):
                    # uint8 wire: back to [0, 1] with the JAX package's
                    # arithmetic (a division, not the step's product with
                    # 1/255, which can differ in the last bit and so put
                    # floor(x * 90) across a threshold)
                    g = g.astype(np.float32) / 255.0
                gts.append(g)
        total = float(torch.stack(losses).sum().cpu()) if losses else 0.0
        if not collect:
            return total, None, None
        if not preds:
            return total, np.zeros((0,)), np.zeros((0,))
        return total, np.concatenate(preds), np.concatenate(gts)

    def fit(self, train_loader, val_loader, test_loader=None, epochs: Optional[int] = None,
            ckpt_path: Optional[str] = None, metrics_path: Optional[str] = None,
            save_every: Optional[int] = None):
        """The reference's epochs: LR (``preset.lr``) and clip threshold (0
        when the preset does not clip) from the preset, train, validate,
        save the best checkpoint (past the save-epoch gate where the preset
        has one), early stop where the preset does; the test loss every
        epoch when there is a test loader. ``save_every=N`` also writes
        {ckpt_path}_epoch{E} every N epochs, keeping the last two."""
        preset = self.preset
        epochs = epochs or preset.epochs
        jsonl = MetricsLogger(metrics_path, echo=False) if metrics_path else None
        best = float("inf")
        prev_avg_grad_norm = 0.0
        early_stop_count = 0
        logs = []
        for epoch in range(1, epochs + 1):
            t0 = time.time()
            lr = preset.lr(epoch, epochs)
            clip_norm = (preset.clip_schedule.threshold(epoch, prev_avg_grad_norm)
                         if preset.norm_clip else 0.0)
            tr = self.train_epoch(train_loader, lr, clip_norm)
            prev_avg_grad_norm = tr["avg_grad_norm"]

            val_loss, _, _ = self.eval_epoch(val_loader)
            save_gate = not preset.save_epoch_gated or epoch > preset.save_epoch
            if save_gate and val_loss < best:
                best = val_loss
                early_stop_count = 0
                if ckpt_path:
                    ckpt.save_state(ckpt_path, self.state_dict())
                print(f"epoch {epoch}: best_val_loss {val_loss:.6f} (saved)")
            else:
                if preset.if_early_stop and save_gate:
                    early_stop_count += 1
                print(f"epoch {epoch}: val_loss {val_loss:.6f}")

            if save_every and ckpt_path and epoch % save_every == 0:
                ckpt.save_state(f"{ckpt_path}_epoch{epoch}", self.state_dict())
                snaps = sorted(glob.glob(f"{ckpt_path}_epoch*"),
                               key=lambda p: int(p.rsplit("epoch", 1)[1]))
                for old in snaps[:-2]:
                    os.remove(old)

            test_loss = 0.0
            if test_loader is not None:
                test_loss, _, _ = self.eval_epoch(test_loader)

            dt = time.time() - t0
            logs.append(EpochLog(epoch, tr["loss"], val_loss, test_loss, lr, tr["avg_grad_norm"],
                                 clip_norm, tr["clip_ratio"], dt))
            if jsonl is not None:
                jsonl.log(epoch=epoch, train_loss=tr["loss"], val_loss=val_loss,
                          test_loss=test_loss, lr=lr, grad_norm=tr["avg_grad_norm"],
                          clip_threshold=clip_norm, clip_ratio=tr["clip_ratio"],
                          steps=tr["steps"], seconds=dt)
            print(f"epoch {epoch}: train_loss {tr['loss']:.6f} test_loss {test_loss:.6f} "
                   f"lr {lr:.2e} grad_norm {tr['avg_grad_norm']:.4f} "
                   f"clip_thr {clip_norm:.4f} clip_ratio {tr['clip_ratio']:.3f} ({dt:.1f}s)")
            if preset.if_early_stop and preset.early_stop and \
                    early_stop_count >= preset.early_stop:
                print(f"early stop at epoch {epoch}")
                break
        return logs

    # ---- state ----------------------------------------------------------

    def state_dict(self) -> dict:
        return {"params": self.model.state_dict(), "opt_state": self.optimizer.state_dict(),
                "step": self.step}

    def load(self, ckpt_path: str) -> None:
        """Restore parameters (with BatchNorm's running statistics),
        optimizer state and step from a checkpoint."""
        state = ckpt.restore_state(ckpt_path, self.state_dict())
        ckpt.load_model_state(self.model, state["params"], ckpt_path)
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
