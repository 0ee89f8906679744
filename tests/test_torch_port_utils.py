"""The port's profiling and debugging utilities against the JAX package's, on
the CPU: ``analytic_flops`` field for field against JAX's on the TINY
duality ADNM-UNet (64^2) and two baselines at 32^2, SmaAt-UNet (depthwise
convolutions, the upsample's matrix products, CBAM's Dense layers called
twice) and ConvLSTM (transposed convolutions, cells JAX scans over time);
``estimate_flops`` (torch's own counter); ``device_memory_stats``; NaN
debugging.

Counts are exact: both sides price the same shapes with the same formulas
(JAX's jaxpr traversal needs no compile; the port runs the forward once).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from adnm_tpu.models import adnm_unet as jmodel
from adnm_tpu.models import registry as jregistry
from adnm_tpu.utils.profiling import analytic_flops as jax_analytic_flops
from adnm_tpu_torch.models import adnm_unet as model
from adnm_tpu_torch.models import registry
from adnm_tpu_torch.utils.debug import enable_nan_debugging
from adnm_tpu_torch.utils.profiling import analytic_flops, device_memory_stats, estimate_flops
from test_torch_port_layers import one_torch_thread  # noqa: F401 (a fixture)
from test_train_modes import TINY

MODELS = {  # (the JAX model, the port's, frame size)
    "ADNMUnet": (lambda: jmodel.ADNMUNet(**TINY), lambda: model.ADNMUNet(**TINY), 64),
    "SmaATUnet": (lambda: jregistry.create_model("SmaATUnet", 5, 3, 6, img_size=32),
                  lambda: registry.create_model("SmaATUnet", 5, 3, 6, img_size=32), 32),
    "ConvLSTM": (lambda: jregistry.create_model("ConvLSTM", 5, 3, 6, img_size=32),
                 lambda: registry.create_model("ConvLSTM", 5, 3, 6, img_size=32), 32),
}


def counts(name: str) -> tuple:
    """(JAX's analytic_flops, the port's, the port's model and input) of the
    eval forward of one clip."""
    jax_fn, port_fn, s = MODELS[name]
    jm = jax_fn()
    x = jnp.zeros((1, 5, 1, s, s))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, train=False))
    variables = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)
    want = jax_analytic_flops(lambda v, v_x: jm.apply(v, v_x, train=False), variables, x)
    pm, px = port_fn().eval(), torch.zeros(1, 5, 1, s, s)
    with torch.no_grad():
        got = analytic_flops(pm, px)
    return want, got, pm, px


@pytest.mark.parametrize("name", sorted(MODELS))
def test_analytic_flops_match_jax_field_for_field(name):
    want, got, pm, px = counts(name)
    assert got == want
    assert want["total"] > 0 and want["n_conv"] > 0
    if name != "ConvLSTM":
        assert want["n_dot"] > 0 and want["n_grouped_conv"] > 0
    with torch.no_grad():
        torch_total = estimate_flops(pm, px)
    if name == "ConvLSTM":  # torch prices a transposed conv by its input: stride^2 less
        assert torch_total < got["total"]
    elif name == "SmaATUnet":  # no transposed conv: the same count
        assert torch_total == got["total"]


def test_convolution_backward_is_priced_as_two_convolutions():
    x = torch.randn(2, 6, 9, 9, requires_grad=True)
    w = torch.randn(6, 3, 3, 3, requires_grad=True)  # groups 2
    fwd = 2.0 * (2 * 6 * 9 * 9) * 3 * 9

    def step():
        F.conv2d(x, w, padding=1, groups=2).sum().backward()

    got = analytic_flops(step)
    assert got["conv_flops"] == 3 * fwd and got["conv_dense_flops"] == 3 * fwd * 2
    assert got["n_conv"] == 3 and got["n_grouped_conv"] == 3 and got["dot_flops"] == 0


def test_device_memory_stats_without_cuda():
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}
    else:
        assert "allocated_bytes.all.current" in device_memory_stats()["cuda:0"]


def test_nan_debugging_raises_on_a_nan_and_switches_off():
    layer = torch.nn.Linear(3, 2)
    x = torch.tensor([[float("nan"), 0.0, 1.0]])
    enable_nan_debugging()
    try:
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="Linear returned a NaN"):
            layer(x)
        layer(torch.ones(1, 3)).sum().backward()  # finite: no error
    finally:
        enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(layer(x)).all()
