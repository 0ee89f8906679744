"""Carry weights between the JAX package's parameter tree and the port.

The port's module paths mirror the JAX parameter paths: the port
parameter ``encoder.encoder4.mixer_0.in_proj.weight`` is the JAX leaf
``encoder/encoder4/mixer_0/in_proj/kernel``. Only the kernels change
layout:

* ``nn.Linear`` weight (out, in) <- Dense kernel (in, out);
* ``nn.Conv2d`` weight (out, in/groups, kh, kw) <- HWIO kernel;
* ``nn.ConvTranspose2d`` weight (in, out, kh, kw) <- the HWIO kernel of the
  equivalent forward conv, which the JAX module flips itself (torch's
  transposed conv does the same flip internally, so no flip here).

Every other parameter keeps its name and shape. The conversion is strict
both ways: every port parameter must be set and every leaf consumed,
except the leaves in ``UNREAD_LEAVES``, which the JAX model creates and
never reads. Uses numpy and torch only: hand over a tree of host arrays
(``jax.device_get(params)``). ``to_jax_params`` goes the other way, for
the port's parameters or for per-parameter tensors such as gradients.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

# Leaves the JAX model creates but never reads, by the port class that
# owns them, with their JAX init value: Block reads beta1/beta2 in place of
# beta3/beta4 (adnm_tpu/models/adnm_unet.py:108-111) and the mixer never
# reads alpha2 (adnm_tpu/mixers/ssd_mixer.py:187).
UNREAD_LEAVES = {
    "Block": {"beta3": lambda m: np.ones(m.num_layers, np.float32),
              "beta4": lambda m: np.ones(m.num_layers, np.float32)},
    "ADNSSDMixer": {"alpha2": lambda m: np.asarray(1.0, np.float32)},
}


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mappings of arrays -> {"a/b/leaf": array}."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _jax_key(module: nn.Module, module_path: str, pname: str) -> str:
    leaf = "kernel" if pname == "weight" and isinstance(
        module, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)) else pname
    return f"{module_path.replace('.', '/')}/{leaf}" if module_path else leaf


def _to_port_layout(module: nn.Module, pname: str, arr: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, dtype=np.float32))  # a copy, 0-d stays 0-d
    if pname != "weight":
        return t
    if isinstance(module, nn.Linear):
        return t.T
    if isinstance(module, nn.ConvTranspose2d):
        return t.permute(2, 3, 0, 1)
    if isinstance(module, nn.Conv2d):
        return t.permute(3, 2, 0, 1)
    return t


def _to_jax_layout(module: nn.Module, pname: str, t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", torch.float32)
    if pname == "weight":
        if isinstance(module, nn.Linear):
            t = t.T
        elif isinstance(module, nn.ConvTranspose2d):
            t = t.permute(2, 3, 0, 1)
        elif isinstance(module, nn.Conv2d):
            t = t.permute(2, 3, 1, 0)
    return t.contiguous().numpy().copy()  # a copy, 0-d stays 0-d


def _param_modules(model: nn.Module):
    """(port parameter name, owning module, its path, parameter name)."""
    modules = dict(model.named_modules())
    for name, _ in model.named_parameters():
        mod_path, _, pname = name.rpartition(".")
        yield name, modules[mod_path], mod_path, pname


def jax_keys(model: nn.Module) -> Dict[str, str]:
    """{port parameter name: "/"-joined path of its JAX leaf}."""
    return {name: _jax_key(module, mod_path, pname)
            for name, module, mod_path, pname in _param_modules(model)}


def unread_leaves(model: nn.Module) -> Dict[str, np.ndarray]:
    """{"/"-joined JAX path: init value} of the leaves the JAX model
    creates for ``model`` and never reads."""
    return {_jax_key(module, mod_path, leaf): init(module)
            for mod_path, module in model.named_modules()
            for leaf, init in UNREAD_LEAVES.get(type(module).__name__, {}).items()}


def from_jax_params(model: nn.Module, tree: Mapping) -> nn.Module:
    """Fill ``model``'s parameters from the JAX ``params`` tree (nested
    mappings of numpy arrays). Raises, naming the path, on a missing leaf,
    a shape mismatch or a leaf that no port parameter consumes."""
    flat = flatten_tree(tree)
    params = dict(model.named_parameters())
    consumed = set(unread_leaves(model))
    with torch.no_grad():
        for name, module, mod_path, pname in _param_modules(model):
            param = params[name]
            key = _jax_key(module, mod_path, pname)
            if key not in flat:
                raise KeyError(f"JAX tree has no leaf {key!r} for port parameter {name!r}")
            value = _to_port_layout(module, pname, flat[key])
            if value.shape != param.shape:
                raise ValueError(f"{key!r}: JAX leaf {tuple(flat[key].shape)} does not fit "
                                 f"port parameter {name!r} {tuple(param.shape)}")
            param.copy_(value)
            consumed.add(key)
    extra = sorted(set(flat) - consumed)
    if extra:
        raise KeyError(f"{len(extra)} JAX leaves match no port parameter: {extra[:10]}")
    return model


def to_jax_params(model: nn.Module,
                  tensors: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """The JAX ``params`` tree (nested dicts of fp32 numpy arrays) of
    ``model``'s parameters or, given ``tensors`` keyed by the port's
    parameter names (gradients, say), of those in the same layouts. The
    leaves the JAX model never reads get their init value, or zeros for
    ``tensors`` (their gradient in JAX). Strict both ways: ``tensors`` must
    hold exactly the model's parameter names, each of its parameter's
    shape."""
    params = dict(model.named_parameters())
    values = params if tensors is None else tensors
    missing, extra = sorted(set(params) - set(values)), sorted(set(values) - set(params))
    if missing or extra:
        raise KeyError(f"tensors lack {missing[:10]} and have no parameter for {extra[:10]}")
    flat = {}
    for name, module, mod_path, pname in _param_modules(model):
        if values[name].shape != params[name].shape:
            raise ValueError(f"{name!r}: tensor {tuple(values[name].shape)} does not fit the "
                             f"parameter {tuple(params[name].shape)}")
        flat[_jax_key(module, mod_path, pname)] = _to_jax_layout(module, pname, values[name])
    for key, value in unread_leaves(model).items():
        flat[key] = value if tensors is None else np.zeros_like(value)
    return unflatten_tree(flat)


def save_params_npz(path: str, tree: Mapping) -> None:
    """Store a params tree as a flat .npz keyed by "/"-joined JAX paths."""
    np.savez(path, **flatten_tree(tree))


def load_params_npz(path: str) -> dict:
    with np.load(path) as npz:
        return unflatten_tree({k: npz[k] for k in npz.files})
