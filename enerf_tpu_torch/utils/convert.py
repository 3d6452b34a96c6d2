"""Carry the JAX package's weights into the port; counterpart of
``_torch_key`` / ``flax_to_torch`` in ``enerf_tpu/utils/convert.py`` (the
port's own copy of the mapping).

The JAX variables arrive as a nested dict of numpy arrays,
``{"params": ..., "batch_stats": ...}``. Each flax leaf maps to a key of
the reference state dict (``feature_net.conv0.0.conv.weight``,
``cost_reg_1.conv9.0.weight``, ``nerf_1.agg.global_fc.0.weight``, ...),
which is also the port's parameter name, with the layout transposes:

- Conv2d  kernel (kh, kw, in, out)        → (out, in, kh, kw)
- Conv3d  kernel (kd, kh, kw, in, out)    → (out, in, kd, kh, kw)
- ConvT3d kernel (kd, kh, kw, out, in)    → (in, out, kd, kh, kw)
- flax's nn.ConvTranspose (kh, kw, in, out), which does not flip its
  kernel                                  → (in, out, kh, kw) flipped in space
- Linear  kernel (in, out)                → (out, in)
- BN scale / bias / mean / var            → weight / bias / running_mean / running_var

Which stages are transposed convs is a property of the network, not of
the flax names (the decoder stages ``conv9`` / ``conv11`` are transposed
convs in ``MinCostRegNet`` and plain ones in ``MinCostRegNetTri``):
``load_flax_variables`` reads it from the port's module; without a module
the stage names ``conv7`` / ``conv9`` / ``conv11`` are transposed.
"""

from __future__ import annotations

from typing import AbstractSet, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from enerf_tpu_torch.models.layers import ConvTransposeBn

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}
_CONVT_STAGES = {"conv7", "conv9", "conv11"}
_DENSE_NAMES = ("sigma", "color_0", "color_1", "linear")


def _seq_name(seg: str) -> str:
    """conv0_0 → conv0.0 (a torch Sequential index)."""
    if "_" in seg and seg.rsplit("_", 1)[-1].isdigit():
        base, idx = seg.rsplit("_", 1)
        return f"{base}.{idx}"
    return seg


def torch_key(path: Tuple[str, ...],
              convt_stages: Optional[AbstractSet[str]] = None,
              flax_convt: AbstractSet[str] = frozenset()) -> Tuple[str, str]:
    """Map a flax tree path (module names + leaf, collection dropped) to a
    reference state-dict key and a transform tag
    ('conv' | 'convT3d' | 'flax_convT' | 'linear' | 'bn' | 'bias' | 'raw').

    ``convt_stages``: the port's dotted names of its ConvTransposeBn
    stages (None: any stage named conv7, conv9 or conv11); ``flax_convt``:
    those of its ConvTranspose2d modules that hold a flax nn.ConvTranspose
    kernel."""
    parts = list(path)
    leaf = parts.pop()
    out: list = []
    transform = None

    def is_stage():
        if convt_stages is None:
            return bool(out) and out[-1] in _CONVT_STAGES
        return ".".join(out) in convt_stages

    i = 0
    while i < len(parts):
        seg = parts[i]
        prev = out[-1] if out else ""
        if seg == "bn_wrap":
            # bn_wrap/bn → bn (ConvBnReLU) or .1 (ConvTransposeBn Sequential)
            if is_stage():
                out[-1] = f"{prev}.1"
            else:
                out.append("bn")
            transform = "bn"
            i += 2
            continue
        if seg == "bn" and i + 1 == len(parts):
            # the JAX BatchNorm wrapper used on its own: <name>/bn → <name>
            transform = "bn"
            i += 1
            continue
        if seg == "conv" and i + 1 == len(parts):
            if is_stage():
                out[-1] = f"{prev}.0"
                transform = "convT3d"
            else:
                out.append("conv")
        elif seg == "linear" and i + 1 == len(parts):
            # LinearReLU: torch Sequential(Linear, ReLU) → .0
            if "." not in prev:
                out[-1] = f"{prev}.0"
            transform = "linear"
        elif seg == "sigma":
            out.append("sigma.0")
            transform = "linear"
        elif seg == "color_0":
            out.append("color.0")
            transform = "linear"
        elif seg == "color_1":
            out.append("color.2")
            transform = "linear"
        elif seg in ("feat_conv", "depth_conv"):
            out.append(f"{seg}.0")
        elif seg.startswith(("cost_reg_", "nerf_")):
            out.append(seg)            # top-level names keep their "_i"
        else:
            out.append(_seq_name(seg))
        i += 1

    if transform is None and leaf in ("kernel", "bias") and any(
            p in _DENSE_NAMES for p in path):
        transform = "linear"
    key = ".".join(out)
    if key in flax_convt and leaf == "kernel":
        transform = "flax_convT"
    if transform == "bn":
        return f"{key}.{_BN_LEAVES[leaf]}", "bn"
    if leaf == "kernel":
        return f"{key}.weight", transform or "conv"
    if leaf == "bias":
        return f"{key}.bias", "bias"
    return f"{key}.{leaf}", "raw"


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _to_torch_layout(arr: np.ndarray, transform: str) -> np.ndarray:
    if transform == "flax_convT":           # (kh, kw, in, out), no flip
        return arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if arr.ndim == 4:                       # conv2d (kh, kw, in, out)
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 5:                       # conv3d / convT3d
        return arr.transpose(4, 3, 0, 1, 2)
    if arr.ndim == 2 and transform == "linear":
        return arr.T
    return arr


def flax_state_dict(variables: Mapping,
                    convt_stages: Optional[AbstractSet[str]] = None,
                    flax_convt: AbstractSet[str] = frozenset()
                    ) -> Dict[str, np.ndarray]:
    """The JAX variables (nested dict of arrays, collections at the top) as a
    reference-named state dict in torch layouts (``torch_key``'s
    ``convt_stages`` and ``flax_convt``)."""
    out: Dict[str, np.ndarray] = {}
    for coll, tree in variables.items():
        for path, arr in _leaves(tree):
            key, transform = torch_key(path, convt_stages, flax_convt)
            out[key] = np.array(_to_torch_layout(arr, transform), order="C")
    return out


def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load the JAX package's variables of ``module``'s counterpart into
    ``module`` (in place; also returned).

    Every JAX leaf must land on a parameter or buffer of the same shape.
    Port entries the JAX tree does not cover are allowed only as whole
    top-level submodules the JAX model never ran (e.g. ``nerf_0`` when
    level 0 is not rendered: flax creates no variables for it), plus BN's
    ``num_batches_tracked``."""
    mods = dict(module.named_modules())
    sd = flax_state_dict(
        variables,
        {n for n, m in mods.items() if isinstance(m, ConvTransposeBn)},
        {n for n, m in mods.items() if isinstance(m, nn.ConvTranspose2d)})
    own = module.state_dict()
    unknown = sorted(set(sd) - set(own))
    if unknown:
        raise KeyError(f"JAX leaves with no port counterpart: {unknown[:8]}")
    covered_tops = {k.split(".")[0] for k in sd}
    missing = [k for k in own if k not in sd
               and not k.endswith("num_batches_tracked")
               and k.split(".")[0] in covered_tops]
    if missing:
        raise KeyError(f"port entries missing from the JAX variables: "
                       f"{missing[:8]}")
    with torch.no_grad():
        for k, arr in sd.items():
            if tuple(own[k].shape) != arr.shape:
                raise ValueError(f"shape mismatch for {k}: JAX {arr.shape}, "
                                 f"port {tuple(own[k].shape)}")
            own[k].copy_(torch.from_numpy(arr).to(own[k].dtype))
    return module


def flax_leaves_by_param(module: nn.Module, tree: Mapping
                         ) -> Dict[str, np.ndarray]:
    """A tree shaped as the JAX model's ``params`` collection (the
    parameters themselves, their gradients, an optimizer moment) as
    ``{port parameter name: array in the port's layout}``, through the
    same key map and transposes as ``flax_state_dict``. Every leaf must land
    on a parameter of ``module`` of the same shape."""
    params = dict(module.named_parameters())
    out = flax_state_dict({"params": tree})
    for k, arr in out.items():
        if k not in params:
            raise KeyError(f"JAX leaf maps to {k}, not a parameter of the port")
        if tuple(params[k].shape) != arr.shape:
            raise ValueError(f"shape mismatch for {k}: JAX {arr.shape}, "
                             f"port {tuple(params[k].shape)}")
    return out
