"""Training the bimamba configurations of the PyTorch port (the chunked SSD
scan, K2, with its backward) against the JAX package, on the CPU.

The TINY model of ``tests/test_torch_port_train.py`` with
``linear_attn_duality=False``: the ADN-SSD mixer (the duality's tree) and
the VSSD mixer (a tree of its own). Every weight is drawn by numpy and
carried into the port; the port's gradients go back to the JAX tree and
are compared leaf by leaf with that file's tolerances. On the CPU the
scan's forward and backward are their plain versions; each JAX trainer is
built and compiled once per module.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adnm_tpu.models import adnm_unet as jmodel
from adnm_tpu.train import Trainer as JTrainer
from adnm_tpu.train import get_preset as jget_preset
from adnm_tpu_torch import convert
from adnm_tpu_torch.models import adnm_unet as model
from adnm_tpu_torch.ops import ssd
from adnm_tpu_torch.train.loop import Trainer
from adnm_tpu_torch.train.presets import get_preset
from test_torch_port_layers import one_torch_thread, random_params  # noqa: F401 (a fixture)
from test_torch_port_train import CPU, TINY_KW, assert_grads_close, flat_grads
from test_train_modes import _batches

MIXERS = {"adnssd": {"linear_attn_duality": False},
          "vssd": {"linear_attn_duality": False, "mixer_type": "vssd"}}


@pytest.fixture(scope="module")
def scan_params():
    return {name: random_params(jmodel.ADNMUNet(**TINY_KW, **kw), jnp.zeros((1, 5, 1, 32, 32)),
                                train=True)
            for name, kw in MIXERS.items()}


@pytest.fixture(scope="module")
def jax_scan_grads(scan_params):
    """{mixer: (batch, loss, flat gradients)} of the JAX trainer's step."""
    (batch,) = _batches(1, 2)
    out = {}
    for name, kw in MIXERS.items():
        t = JTrainer(jmodel.ADNMUNet(**TINY_KW, **kw),
                     jget_preset("ADNMUnet", 5, 2, 6, "Shanghai"),
                     input_frames=5, output_frames=2, img_size=32, seed=0)
        t.state = t.state.replace(params=jax.tree.map(jnp.asarray, scan_params[name]))
        loss, grads, _ = jax.jit(t._grads_impl)(t.state, batch)
        out[name] = (batch, float(loss), convert.flatten_tree(jax.device_get(grads)))
    return out


def scan_trainer(params, mixer: str, remat_forward: bool = False, **model_kw) -> Trainer:
    t = Trainer(model.ADNMUNet(**TINY_KW, **MIXERS[mixer], **model_kw),
                get_preset("ADNMUnet", 5, 2, 6, "Shanghai"), 5, CPU, seed=0,
                remat_forward=remat_forward)
    convert.from_jax_params(t.model, params[mixer])
    return t


@pytest.mark.parametrize("mixer", list(MIXERS))
def test_scan_model_loss_and_every_gradient_match_jax(scan_params, jax_scan_grads, mixer):
    """The bimamba step of the ADN-SSD and VSSD models: loss and every
    gradient leaf (the refiner under remat, as the JAX model)."""
    batch, loss_want, want = jax_scan_grads[mixer]
    t = scan_trainer(scan_params, mixer)
    assert t.model.refiner.remat
    loss, grads = t.grads(batch)
    np.testing.assert_allclose(float(loss), loss_want, rtol=1e-5)
    got = flat_grads(t, grads)
    assert_grads_close(got, want)
    # the scans' decays get their gradients: the refiner mixers' A_log (at
    # the 1^2 Blocks, one token, A multiplies the zero initial state only)
    a_logs = [k for k in want if k.startswith("refiner/") and k.endswith("/A_log")]
    assert len(a_logs) == 4 and all(np.abs(got[k]).min() > 0 for k in a_logs)


@pytest.mark.parametrize("remat_forward", [False, True])
def test_remat_gives_the_same_bimamba_gradients(scan_params, remat_forward):
    """Refiner remat on and off, and the whole forward under checkpoint: the
    recomputed scans repeat the same fp32 operations."""
    (batch,) = _batches(1, 2)
    off = scan_trainer(scan_params, "adnssd", refiner_remat=False)
    on = scan_trainer(scan_params, "adnssd", remat_forward, refiner_remat=True)
    loss_off, g_off = off.grads(batch)
    loss_on, g_on = on.grads(batch)
    assert float(loss_on) == float(loss_off)
    for name in g_off:
        torch.testing.assert_close(g_on[name], g_off[name], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("refiner_remat", [False, True])
def test_chip_smoke_counts_k2_calls_of_a_bimamba_step(scan_params, monkeypatch, refiner_remat):
    """The scan's forward and backward calls of one training step, as
    chip_smoke.py asserts them per step on the card: 20 backward, and 20
    forward plus 8 where remat recomputes the four refiner Blocks."""
    import chip_smoke

    calls = {"forward": 0, "backward": 0}
    scan, backward = ssd._scan, ssd.ssd_chunked_scan_backward

    def counted_scan(*a):
        calls["forward"] += 1
        return scan(*a)

    def counted_backward(*a):
        calls["backward"] += 1
        return backward(*a)

    monkeypatch.setattr(ssd, "_scan", counted_scan)
    monkeypatch.setattr(ssd, "ssd_chunked_scan_backward", counted_backward)
    (batch,) = _batches(1, 2)
    t = scan_trainer(scan_params, "adnssd", refiner_remat=refiner_remat)
    t.train_step(torch.from_numpy(batch), 1e-3, 0.025)
    assert calls == {"forward": chip_smoke.K2_PER_STEP if refiner_remat
                     else chip_smoke.K2_PER_FORWARD, "backward": chip_smoke.K2B_PER_STEP}
