"""Carry variables between the JAX package and the port's modules.

The port's module attributes follow the flax module tree, so a flax path
``ConvBlock_0/ConvLayer_0/EqualConv_0/Conv_0/kernel`` is the state-dict key
``ConvBlock_0.ConvLayer_0.EqualConv_0.Conv_0.weight``. How a leaf maps goes
by the kind of module that holds it, which flax's names carry (``Conv_<i>``,
``EqualConv_<i>``, ``BatchNorm_<i>``):

- convolutions: kernels go HWIO → OIHW as ``weight``, ``bias`` stays;
- batch norms: ``scale``/``bias``/``mean``/``var`` become
  ``weight``/``bias``/``running_mean``/``running_var``;
- every other module (the ViT's ``Dense``, ``LayerNorm``, ``Embed`` and
  attention projections, its raw ``embed_token``, the conditional prior's
  ``mu`` and ``log_std``, ``EqualDense``, the Gaussian Fourier projection's
  ``weight``) keeps flax's names and layouts: a Dense kernel is [in, out],
  an attention projection's [dim, H, d] or [H, d, dim];
- the codebook prior's learned codebook (``params/.../codebook``) is the
  parameter ``atoms``, and its k-means state (``prior_stats/.../codebook``,
  a ``CodebookState``) the buffers ``kmeans.codebook``, ``kmeans.n_obs``,
  ``kmeans.s1`` and ``kmeans.initialized``.

The ``cache`` collection (attention KV caches) is runtime state: it is not
carried across.
:func:`state_dict_to_jax_variables` is the inverse, so tests can hold trained
parameters and running statistics against the JAX package's key by key.

A transport operator's state crosses as nested mappings of numpy arrays
(:func:`discrete_transport_state`, :func:`gaussian_transport_state`,
:func:`gmm_transport_state`): the JAX state's leaves become the port's
operator state, leaf by leaf under the same names.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["jax_variables_to_state_dict", "load_jax_variables",
           "state_dict_to_jax_variables", "discrete_transport_state",
           "gaussian_transport_state", "gmm_transport_state"]

_BATCH_NORM = {"scale": "weight", "bias": "bias", "mean": "running_mean",
               "var": "running_var"}
_CONV = {"kernel": "weight", "bias": "bias"}
# leaves of the modules that keep flax's names, and the ranks a kernel takes
_FLAX = {name: name for name in ("kernel", "bias", "scale", "embedding", "embed_token",
                                 "mu", "log_std", "weight")}
_FLAX["codebook"] = "atoms"
_KMEANS = ("codebook", "n_obs", "s1", "initialized")
_FLAX_KERNEL_RANKS = (2, 3)


def _kind(parents) -> str:
    """"batch_norm", "conv" or "flax", from the name of the module holding
    the leaf."""
    owner = parents[-1] if parents else ""
    if owner.startswith("BatchNorm"):
        return "batch_norm"
    if owner.startswith(("Conv_", "EqualConv_")):
        return "conv"
    return "flax"


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if dataclasses.is_dataclass(v):  # a state of the JAX package (CodebookState)
            v = {f.name: getattr(v, f.name) for f in dataclasses.fields(v)}
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v)
    return flat


def jax_variables_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ..., "prior_stats": ...}`` nested
    dicts of arrays → a state dict of float32 tensors (a ``cache``
    collection is left out)."""
    unknown = set(variables) - {"params", "batch_stats", "prior_stats", "cache"}
    if unknown:
        raise ValueError(f"no mapping for variable collections {sorted(unknown)}")
    state = {}
    for path, value in _flatten(variables.get("prior_stats", {})).items():
        *parents, owner, leaf = path
        if owner != "codebook" or leaf not in _KMEANS:
            raise ValueError(f"no mapping for prior_stats/{'/'.join(path)}")
        state[".".join([*parents, "kmeans", leaf])] = torch.from_numpy(
            np.array(value, np.float32))
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})).items():
            *parents, leaf = path
            kind = _kind(parents)
            names = {"batch_norm": _BATCH_NORM, "conv": _CONV, "flax": _FLAX}[kind]
            if leaf not in names or (kind == "flax" and collection != "params"):
                raise ValueError(f"no mapping for {collection}/{'/'.join(path)}")
            if leaf == "kernel" and kind == "conv":
                if value.ndim != 4:
                    raise ValueError(f"{'/'.join(path)}: expected an HWIO conv kernel, "
                                     f"got shape {value.shape}")
                value = value.transpose(3, 2, 0, 1)
            elif leaf == "kernel" and value.ndim not in _FLAX_KERNEL_RANKS:
                raise ValueError(f"{'/'.join(path)}: expected a Dense or attention kernel, "
                                 f"got shape {value.shape}")
            key = ".".join([*parents, names[leaf]])
            state[key] = torch.from_numpy(np.array(value, np.float32))
    return state


def load_jax_variables(module: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Load JAX variables into ``module`` with ``strict=True``: a parameter
    missing on either side raises."""
    module.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return module


_BATCH_NORM_INV = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                   "running_mean": ("batch_stats", "mean"),
                   "running_var": ("batch_stats", "var")}
_CONV_INV = {"weight": ("params", "kernel"), "bias": ("params", "bias")}
_FLAX_INV = {port: ("params", name) for name, port in _FLAX.items()}


def state_dict_to_jax_variables(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """A state dict → ``{"params": ..., "batch_stats": ...}`` (and
    ``"prior_stats"`` for a k-means codebook) nested dicts of float32 numpy
    arrays in the JAX package's layout (conv kernels HWIO)."""
    variables: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, tensor in state.items():
        *parents, leaf = key.split(".")
        if parents and parents[-1] == "kmeans":
            node = variables.setdefault("prior_stats", {})
            for p in [*parents[:-1], "codebook"]:
                node = node.setdefault(p, {})
            node[leaf] = tensor.detach().float().cpu().numpy()
            continue
        kind = _kind(parents)
        names = {"batch_norm": _BATCH_NORM_INV, "conv": _CONV_INV, "flax": _FLAX_INV}[kind]
        if leaf not in names:
            raise ValueError(f"no mapping for {key}")
        collection, name = names[leaf]
        value = tensor.detach().float().cpu().numpy()
        if name == "kernel" and kind == "conv":
            value = value.transpose(2, 3, 1, 0)
        node = variables[collection]
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(value)
    return variables


def _flat_state(state: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mappings of arrays → numpy arrays by dotted name; a None
    leaf (the Gaussian's Kahan buffers without compensation) has none."""
    out = {}
    for name, value in state.items():
        if value is None:
            continue
        if isinstance(value, Mapping):
            out.update(_flat_state(value, f"{prefix}{name}."))
        else:
            out[prefix + name] = np.asarray(value)
    return out


def _operator_state(state: Mapping[str, Any], operator, device):
    """A JAX operator state as nested mappings → the port's state for
    ``operator`` (same configuration), on ``device``; a missing, extra or
    reshaped leaf raises."""
    template = operator.init(torch.Generator().manual_seed(0))
    return type(template).from_arrays(_flat_state(state), template, torch.device(device))


def discrete_transport_state(state: Mapping[str, Any], operator, device="cpu"):
    """A ``DiscreteTransportState`` of the JAX package, as nested mappings of
    arrays, → the port's state for ``operator`` (a ``DiscreteTransport`` of
    the same configuration; a shape that does not fit raises).

    :param state: ``{"source": {"codebook", "n_obs", "s1", "initialized"},
        "target": {...}, "plan": ..., "fitted": ...}``
    """
    return _operator_state(state, operator, device)


def gaussian_transport_state(state: Mapping[str, Any], operator, device="cpu"):
    """A ``GaussianTransportState`` of the JAX package → the port's, for a
    ``GaussianTransport`` of the same configuration (compensated or not: the
    Kahan buffers ``c1``, ``c2`` are None without compensation).

    :param state: ``{"source": {"n", "s1", "s2", "c1", "c2"}, "target": {...},
        "mean_source", "mean_target", "T", "Cw", "fitted"}``
    """
    return _operator_state(state, operator, device)


def gmm_transport_state(state: Mapping[str, Any], operator, device="cpu"):
    """A ``GMMTransportState`` of the JAX package → the port's, for a
    ``GMMTransport`` of the same configuration.

    :param state: ``{"source": {"mean", "cov", "n_obs", "s1", "s2",
        "initialized"}, "target": {...}, "plan": ..., "fitted": ...}``
    """
    return _operator_state(state, operator, device)
