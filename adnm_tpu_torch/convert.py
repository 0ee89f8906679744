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

A module whose other parameters are laid out otherwise than in JAX names
the permutation in ``jax_layouts`` ({parameter name: port axes of the JAX
leaf's axes}; ConvLSTM's peepholes, (sh, sw, nf) in JAX, are (nf, sh,
sw)). Every other parameter keeps its name and shape. A module with
running statistics (``BatchNorm``) lists its buffers in ``batch_stats``:
they are the leaves of the JAX ``batch_stats`` tree at the same paths.

The conversion is strict both ways: every port parameter must be set and
every leaf consumed, except the leaves in ``UNREAD_LEAVES``, which the
JAX model creates and never reads; the same for the ``batch_stats`` tree
when one is given. Uses numpy and torch only: hand over trees of host
arrays (``jax.device_get(params)``). ``to_jax_params`` and
``to_jax_batch_stats`` go the other way, ``to_jax_params`` for the port's
parameters or for per-parameter tensors such as gradients.
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
    perm = getattr(module, "jax_layouts", {}).get(pname)
    if perm is not None:
        return t.permute(*perm).contiguous()
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
    perm = getattr(module, "jax_layouts", {}).get(pname)
    if perm is not None:
        t = t.permute(*np.argsort(perm).tolist())
    elif pname == "weight":
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


def _stat_buffers(model: nn.Module):
    """(JAX ``batch_stats`` path, buffer) of every running statistic."""
    for mod_path, module in model.named_modules():
        for name in getattr(module, "batch_stats", ()):
            key = f"{mod_path.replace('.', '/')}/{name}" if mod_path else name
            yield key, getattr(module, name)


def to_jax_batch_stats(model: nn.Module) -> dict:
    """The JAX ``batch_stats`` tree (nested dicts of fp32 numpy arrays) of
    ``model``'s running statistics; empty for a model without BatchNorm."""
    return unflatten_tree({key: buf.detach().to("cpu", torch.float32).numpy().copy()
                           for key, buf in _stat_buffers(model)})


def from_jax_params(model: nn.Module, tree: Mapping,
                    batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Fill ``model``'s parameters from the JAX ``params`` tree (nested
    mappings of numpy arrays) and, given the JAX ``batch_stats`` tree, its
    running statistics (else they keep their values). Raises, naming the
    path, on a missing leaf, a shape mismatch or a leaf that nothing in the
    port consumes."""
    if batch_stats is not None:
        stats = flatten_tree(batch_stats)
        with torch.no_grad():
            for key, buf in _stat_buffers(model):
                if key not in stats:
                    raise KeyError(f"JAX batch_stats has no leaf {key!r}")
                if tuple(stats[key].shape) != tuple(buf.shape):
                    raise ValueError(f"batch_stats {key!r}: {tuple(stats[key].shape)} does not "
                                     f"fit {tuple(buf.shape)}")
                buf.copy_(torch.from_numpy(np.array(stats[key], dtype=np.float32)))
        extra = sorted(set(stats) - {key for key, _ in _stat_buffers(model)})
        if extra:
            raise KeyError(f"{len(extra)} batch_stats leaves match no port buffer: {extra[:10]}")
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
