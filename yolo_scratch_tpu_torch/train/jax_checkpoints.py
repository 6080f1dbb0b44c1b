"""Read the JAX package's checkpoints into the port's layout, in the port's
own code: nothing of JAX, flax, orbax, tensorstore or libzstd is needed.

The JAX package's ``CheckpointManager._save_tree`` writes each of ``last``
and ``best`` in one of two forms, beside ``<name>.meta.json``:

* the orbax directory ``<dir>/<name>/``: ``_METADATA`` (JSON: each leaf's
  key path, ``key_type`` 1 a sequence index and 2 a dict key, and its value
  type; ``skip_deserialize`` for optax's empty states and an absent EMA),
  and an OCDBT database (``utils/ocdbt.py``) holding one zarr v2 array
  (``utils/zarr2.py``) per leaf, named by the key path joined with dots;
* the npz fallback (when orbax is missing): ``<name>.npz``, the leaves in
  ``jax.tree_util`` flatten order, and ``<name>.treedef.json``, the
  treedef's ``str``.

:func:`read_orbax` and :func:`read_jax_npz` give the same nested dict of
numpy arrays, a sequence's items under int keys, an empty optax state as
``None`` and an absent EMA as ``{}`` (as orbax restores them).
:func:`port_tree_from_jax` maps that tree to the port's checkpoint layout
(``train/checkpoints.py``). :func:`find_jax_checkpoint` says which form, if
any, a directory holds.
"""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from yolo_scratch_tpu_torch.utils.ocdbt import OcdbtStore
from yolo_scratch_tpu_torch.utils.weights import state_dict_from_jax
from yolo_scratch_tpu_torch.utils.zarr2 import read_array

# the fields of the optax states a JAX opt_state holds, in order (the
# treedef's repr names a namedtuple's type, not its fields)
OPTAX_FIELDS = {
    "ScaleByAdamState": ("count", "mu", "nu"),
    "ScaleByScheduleState": ("count",),
    "EmptyState": (),
}


def find_jax_checkpoint(directory, name: str) -> Optional[str]:
    """"orbax" or "npz" when ``directory`` holds the JAX package's checkpoint
    ``name`` in that form, else None."""
    d = Path(directory)
    if (d / name / "_METADATA").is_file() and (d / name / "manifest.ocdbt").is_file():
        return "orbax"
    if (d / f"{name}.npz").is_file() and (d / f"{name}.treedef.json").is_file():
        return "npz"
    return None


def _insert(tree: Dict, path: List, value: Any, where: str) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ValueError(f"{where}: key path {path} runs through a leaf")
    if path[-1] in node:
        raise ValueError(f"{where}: key path {path} given twice")
    node[path[-1]] = value


def read_orbax(directory) -> Dict[str, Any]:
    """The tree of the orbax checkpoint directory ``directory`` (a
    ``StandardCheckpointer`` save: OCDBT, zarr v2, zstd)."""
    d = Path(directory)
    meta_path = d / "_METADATA"
    try:
        meta = json.loads(meta_path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"{meta_path}: {e}") from e
    if meta.get("use_zarr3") or not meta.get("use_ocdbt", False):
        raise ValueError(f"{meta_path}: use_ocdbt={meta.get('use_ocdbt')}, "
                         f"use_zarr3={meta.get('use_zarr3')}; only OCDBT with zarr v2 is read")
    tree: Dict[str, Any] = {}
    with OcdbtStore(d) as store:
        try:
            entries = [(e["key_metadata"], e["value_metadata"])
                       for e in meta["tree_metadata"].values()]
        except (KeyError, TypeError, AttributeError) as e:
            raise ValueError(f"{meta_path}: malformed tree_metadata ({e!r})") from e
        for keys, vm in entries:
            path = []
            for k in keys:
                if k["key_type"] == 1:
                    path.append(int(k["key"]))
                elif k["key_type"] == 2:
                    path.append(k["key"])
                else:
                    raise ValueError(f"{meta_path}: key type {k['key_type']} of {k['key']!r}")
            name = ".".join(str(k["key"]) for k in keys)
            if vm.get("skip_deserialize") and vm["value_type"] == "None":
                value = None
            elif vm.get("skip_deserialize") and vm["value_type"] == "Dict":
                value = {}
            elif vm.get("skip_deserialize"):
                raise ValueError(f"{meta_path}: {name}: empty value of type "
                                 f"{vm['value_type']!r}")
            elif vm["value_type"] == "np.ndarray":
                try:
                    value = read_array(store, name)
                except ValueError as e:
                    raise ValueError(f"{d}: {e}") from e
            else:
                raise ValueError(f"{meta_path}: {name}: value type {vm['value_type']!r}")
            _insert(tree, path, value, str(meta_path))
    return tree


# -- the npz fallback ------------------------------------------------------

_TOKEN = re.compile(r"""\s*(?:
    (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<int>-?\d+)
  | (?P<custom>CustomNode\(namedtuple\[(?P<nt>\w+)\],)
  | (?P<word>PyTreeDef\(|None|\*)
  | (?P<punct>[{}()\[\],:])
)""", re.VERBOSE)


class _TreedefParser:
    """Recursive descent over ``str(treedef)``, handing out ``leaves`` in
    order: ``*`` a leaf, ``None``, dicts, tuples and lists (int keys), and
    optax's namedtuples (:data:`OPTAX_FIELDS`; an empty one is None)."""

    def __init__(self, text: str, leaves: List[np.ndarray], where: str):
        self.toks = []
        pos = 0
        while pos < len(text):
            m = _TOKEN.match(text, pos)
            if m is None or m.end() == pos:
                if text[pos:].strip() == "":
                    break
                raise ValueError(f"{where}: cannot parse the treedef at {text[pos:pos + 40]!r}")
            kind = next(k for k in ("str", "int", "custom", "word", "punct") if m.group(k))
            self.toks.append((kind, m.group("nt") if kind == "custom" else m.group(kind)))
            pos = m.end()
        self.i, self.leaves, self.n_leaf, self.where = 0, leaves, 0, where

    def fail(self, what: str) -> ValueError:
        return ValueError(f"{self.where}: treedef token {self.i}: {what}")

    def next(self, want: Optional[str] = None) -> str:
        if self.i >= len(self.toks):
            raise self.fail("ends early")
        kind, val = self.toks[self.i]
        if want is not None and val != want:
            raise self.fail(f"{val!r} where {want!r} was expected")
        self.i += 1
        return val

    def peek(self) -> str:
        return self.toks[self.i][1] if self.i < len(self.toks) else ""

    def items(self, close: str, one) -> List:
        out = []
        while self.peek() != close:
            out.append(one())
            if self.peek() == ",":
                self.next()
        self.next(close)
        return out

    def key(self):
        kind = self.toks[self.i][0] if self.i < len(self.toks) else ""
        val = self.next()
        if kind == "str":
            return ast.literal_eval(val)
        if kind == "int":
            return int(val)
        raise self.fail(f"dict key {val!r}")

    def node(self) -> Any:
        kind, val = self.toks[self.i] if self.i < len(self.toks) else ("", "")
        if val == "*":
            self.next()
            if self.n_leaf >= len(self.leaves):
                raise self.fail("more leaves in the treedef than in the npz")
            self.n_leaf += 1
            return self.leaves[self.n_leaf - 1]
        if val == "None":
            self.next()
            return None
        if val == "{":
            self.next()

            def pair():
                k = self.key()
                self.next(":")
                return k, self.node()
            return dict(self.items("}", pair))
        if val in ("(", "["):
            self.next()
            return dict(enumerate(self.items(")" if val == "(" else "]", self.node)))
        if kind == "custom":
            self.next()
            if val not in OPTAX_FIELDS:
                raise self.fail(f"namedtuple {val!r}: its fields are not known here")
            self.next("[")
            children = self.items("]", self.node)
            self.next(")")
            fields = OPTAX_FIELDS[val]
            if len(children) != len(fields):
                raise self.fail(f"{val} has {len(children)} children, {len(fields)} fields")
            return dict(zip(fields, children)) if fields else None
        raise self.fail(f"unexpected {val!r}")

    def parse(self) -> Any:
        self.next("PyTreeDef(")
        tree = self.node()
        self.next(")")
        if self.i != len(self.toks) or self.n_leaf != len(self.leaves):
            raise self.fail(f"{self.n_leaf} leaves used of {len(self.leaves)}")
        return tree


def read_jax_npz(path) -> Dict[str, Any]:
    """The tree of the npz fallback ``<name>.npz`` (``path``, with or without
    its suffix) and its ``<name>.treedef.json``."""
    base = str(path)[:-4] if str(path).endswith(".npz") else str(path)
    npz_path, treedef_path = Path(base + ".npz"), Path(base + ".treedef.json")
    with np.load(npz_path, allow_pickle=False) as z:
        leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
    return _TreedefParser(treedef_path.read_text(), leaves, str(treedef_path)).parse()


# -- to the port's layout --------------------------------------------------

def _leaf_shapes(tree: Mapping, path=()):
    """(path, shape) of each leaf in ``jax.tree_util`` flatten order (sorted
    keys at every level)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaf_shapes(v, path + (k,))
        else:
            yield path + (k,), np.shape(v)


def _unravel(flat: np.ndarray, params: Mapping, what: str) -> Dict:
    """Split a flat (N,) vector into the params tree's shapes, in
    ``jax.flatten_util.ravel_pytree`` order."""
    leaves = list(_leaf_shapes(params))
    n = sum(int(np.prod(s)) for _, s in leaves)
    if flat.ndim != 1 or flat.shape[0] != n:
        raise ValueError(f"{what}: flat vector of shape {flat.shape}, the parameters hold {n}")
    out: Dict = {}
    at = 0
    for path, shape in leaves:
        size = int(np.prod(shape))
        _insert(out, list(path), flat[at:at + size].reshape(shape), what)
        at += size
    return out


def _param_tree(tree: Any, params: Mapping, what: str) -> Dict[str, torch.Tensor]:
    """A params-shaped tree (or its flat vector) as port parameter names."""
    if isinstance(tree, np.ndarray):
        tree = _unravel(tree, params, what)
    return state_dict_from_jax({"params": tree, "batch_stats": {}})


def port_tree_from_jax(raw: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX package's checkpoint tree (``params``, ``batch_stats``,
    ``opt_state``, ``ema_params``, ``step``) in the port's layout:
    ``{"model": state_dict, "opt_state": {"count", "mu", "nu"}, "ema", "step"}``.

    Weights and BN statistics go through ``utils/weights.py::state_dict_from_jax``;
    the EMA and optax's ``ScaleByAdamState`` (``opt_state[1][0]``) map leaf by
    leaf under the same names and the same HWIO -> OIHW permute, per-leaf or
    as the flat (N,) vectors of the JAX package's ``flat_opt`` state, whose
    length must be the parameters' count. ``check_checkpoint`` guards the
    architecture against the model the caller builds."""
    params = raw["params"]
    try:
        adam = raw["opt_state"][1][0]
        count, mu, nu = adam["count"], adam["mu"], adam["nu"]
    except (KeyError, TypeError, IndexError):
        raise ValueError("opt_state has no ScaleByAdamState at [1][0] (not the JAX "
                         "package's clip + AdamW chain)") from None
    ema = raw.get("ema_params")
    return {
        "model": state_dict_from_jax({"params": params, "batch_stats": raw["batch_stats"]}),
        "opt_state": {"count": int(np.asarray(count)),
                      "mu": _param_tree(mu, params, "opt_state mu"),
                      "nu": _param_tree(nu, params, "opt_state nu")},
        "ema": _param_tree(ema, params, "ema_params") if ema is not None and (
            isinstance(ema, np.ndarray) or len(ema)) else {},
        "step": int(np.asarray(raw["step"])),
    }


def read_jax_checkpoint(directory, name: str) -> Optional[Dict[str, Any]]:
    """The JAX package's checkpoint ``name`` under ``directory`` in the port's
    layout (:func:`port_tree_from_jax`), or None when there is none."""
    form = find_jax_checkpoint(directory, name)
    if form is None:
        return None
    path = Path(directory) / name
    raw = read_orbax(path) if form == "orbax" else read_jax_npz(path)
    try:
        return port_tree_from_jax(raw)
    except KeyError as e:
        raise ValueError(f"{path}: not a JAX train-state checkpoint (no {e})") from None
