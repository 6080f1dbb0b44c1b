"""Weight bridge from the JAX package's variable tree to the port's
``state_dict`` (the inverse of ``utils/torch_import.py``'s
``convert_reference_state_dict``).

* path ``model_23/cv2_0_2/kernel`` -> key ``model.23.cv2.0.2.weight``, with
  HWIO -> OIHW;
* ``params .../bn/{scale,bias}`` -> ``bn.{weight,bias}``;
* ``batch_stats .../bn/{mean,var}`` -> ``bn.running_{mean,var}`` (plus a
  zero ``num_batches_tracked``, which the JAX tree does not carry).
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


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` tree of arrays -> port ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf, arr in _leaves(variables["params"]):
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        prefix = ".".join(_split_numeric(p) for p in path)
        if path[-1] == "bn":
            out[f"{prefix}.{_BN_PARAM[leaf]}"] = t
        elif leaf == "kernel":
            out[f"{prefix}.weight"] = t.permute(3, 2, 0, 1).contiguous()
        elif leaf == "bias":
            out[f"{prefix}.bias"] = t
        else:
            raise ValueError(f"unhandled param {'/'.join(path + (leaf,))}")
    for path, leaf, arr in _leaves(variables.get("batch_stats", {})):
        prefix = ".".join(_split_numeric(p) for p in path)
        out[f"{prefix}.running_{leaf}"] = torch.from_numpy(np.array(arr, dtype=np.float32))
        out[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return out


def load_reference_checkpoint(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load a reference-layout checkpoint (``last.pt``/``best.pt``, or a bare
    ``state_dict``) into ``model`` in place, as the JAX package's
    ``utils/torch_import.py::load_reference_checkpoint`` reads one: the
    state_dict under ``model_state_dict`` or ``model``, else the file
    itself; the reference's frozen DFL conv (``dfl`` keys) has no
    counterpart and is dropped. Tensors only (``weights_only``). Every other
    key must match; only ``num_batches_tracked``, which the JAX tree does not
    carry either, may be missing."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt.get("model", ckpt))
    sd = {k: v for k, v in sd.items() if "dfl" not in k.split(".")}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"{path}: missing {missing[:5]}, unexpected {unexpected[:5]}")
    return model
