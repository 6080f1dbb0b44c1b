"""Weight bridge from the JAX package's variable tree to the port's
``state_dict`` (the inverse of ``utils/torch_import.py``'s
``convert_reference_state_dict``).

* path ``model_23/cv2_0_2/kernel`` -> key ``model.23.cv2.0.2.weight``, with
  HWIO -> OIHW;
* ``params .../bn/{scale,bias}`` -> ``bn.{weight,bias}``;
* ``batch_stats .../bn/{mean,var}`` -> ``bn.running_{mean,var}`` (plus a
  zero ``num_batches_tracked``, which the JAX tree does not carry);
* the int8 ``quant`` collection (``nn/quant.py``), ``.../{w_q,s_w,s_act}``
  -> the block's buffers of those names, ``w_q`` HWIO -> OIHW and int8, the
  scales f32 as they are (``ConvBNAct`` loads them into a block that has
  none).

A YOLOX or legacy tree (top-level ``backbone``) keeps its tokens: the
port's YOLOX and legacy modules carry the flax names
(``backbone/dark2_csp/m_0_cv1`` -> ``backbone.dark2_csp.m_0_cv1``,
``backbone/stage_p2/blocks_0_0`` -> ``backbone.stage_p2.blocks_0_0``, and
the legacy head's biased convs ``head/bbox_0_1/{kernel,bias}`` ->
``head.bbox_0_1.{weight,bias}``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


_BN_PARAM = {"scale": "weight", "bias": "bias"}


def _split_numeric(tok: str) -> str:
    """'cv2_0_2' -> 'cv2.0.2' (inverse of the JAX side's token merge)."""
    head, *rest = tok.split("_")
    return head + "".join(f".{p}" if p.isdigit() else f"_{p}" for p in rest)


def _leaves(tree: Mapping[str, Any], path: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path, k, v


def state_dict_from_jax(variables: Mapping[str, Any],
                        dtype: np.dtype = np.float32) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"[, "quant"]}`` tree of arrays -> port
    ``state_dict``, its parameters and BN statistics in ``dtype``."""
    out: Dict[str, torch.Tensor] = {}
    token = (lambda t: t) if "backbone" in variables["params"] else _split_numeric
    for path, leaf, arr in _leaves(variables["params"]):
        t = torch.from_numpy(np.array(arr, dtype=dtype))
        prefix = ".".join(token(p) for p in path)
        if path[-1] == "bn":
            out[f"{prefix}.{_BN_PARAM[leaf]}"] = t
        elif leaf == "kernel":
            out[f"{prefix}.weight"] = t.permute(3, 2, 0, 1).contiguous()
        elif leaf == "bias":
            out[f"{prefix}.bias"] = t
        else:
            raise ValueError(f"unhandled param {'/'.join(path + (leaf,))}")
    for path, leaf, arr in _leaves(variables.get("batch_stats", {})):
        prefix = ".".join(token(p) for p in path)
        out[f"{prefix}.running_{leaf}"] = torch.from_numpy(np.array(arr, dtype=dtype))
        out[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    for path, leaf, arr in _leaves(variables.get("quant", {})):
        prefix = ".".join(token(p) for p in path)
        if leaf == "w_q":
            out[f"{prefix}.w_q"] = torch.from_numpy(
                np.array(arr, dtype=np.int8)).permute(3, 2, 0, 1).contiguous()
        elif leaf in ("s_w", "s_act"):
            out[f"{prefix}.{leaf}"] = torch.from_numpy(np.array(arr, dtype=np.float32))
        else:
            raise ValueError(f"unhandled quant leaf {'/'.join(path + (leaf,))}")
    return out


def reference_state_dict(path) -> Dict[str, torch.Tensor]:
    """The state_dict of a reference-layout checkpoint file: under
    ``model_state_dict`` or ``model``, else the file itself, without the
    reference's frozen DFL conv (``dfl`` keys). Tensors only
    (``weights_only``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt.get("model", ckpt))
    return {k: v for k, v in sd.items() if "dfl" not in k.split(".")}


def load_reference_checkpoint(model: torch.nn.Module, path,
                              state: Mapping[str, torch.Tensor] | None = None) -> torch.nn.Module:
    """Load a reference-layout checkpoint (``last.pt``/``best.pt``, or a bare
    ``state_dict``) into ``model`` in place, as the JAX package's
    ``utils/torch_import.py::load_reference_checkpoint`` reads one: the
    state_dict under ``model_state_dict`` or ``model``, else the file
    itself; the reference's frozen DFL conv (``dfl`` keys) has no
    counterpart and is dropped. Tensors only (``weights_only``). Every other
    key must match; only ``num_batches_tracked``, which the JAX tree does not
    carry either, may be missing. ``state``: the file's
    :func:`reference_state_dict`, when the caller has read it already."""
    sd = reference_state_dict(path) if state is None else state
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"{path}: missing {missing[:5]}, unexpected {unexpected[:5]}")
    return model


def merge_pretrained(init: Mapping[str, torch.Tensor], loaded: Mapping[str, torch.Tensor],
                     strict: bool = False) -> Tuple[Dict[str, torch.Tensor], list]:
    """Overlay ``loaded`` onto the ``init`` state dict (the JAX package's
    ``utils/torch_import.py::merge_pretrained``, on state dicts): a key
    missing from ``loaded``, or of another shape (a different nc head or
    input channels), keeps its init value and is reported. ``strict=True``
    raises on the first one instead.

    Returns (merged state dict, skipped keys)."""
    merged: Dict[str, torch.Tensor] = {}
    skipped: list = []
    for k, v in init.items():
        if k not in loaded:
            if strict:
                raise KeyError(f"missing {k} in pretrained weights")
            skipped.append(k)
            merged[k] = v
        elif tuple(loaded[k].shape) != tuple(v.shape):
            if strict:
                raise ValueError(f"shape mismatch at {k}: {tuple(loaded[k].shape)} vs "
                                 f"{tuple(v.shape)}")
            skipped.append(k)
            merged[k] = v
        else:
            merged[k] = loaded[k].to(dtype=v.dtype)
    return merged, skipped
