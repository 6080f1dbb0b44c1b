"""The numbers that decide ``correct``, each held against its limit.

Deploy cells compare in two stages, since at conf 0 a bf16 forward's
rounding reorders near-equal scores and so changes which boxes survive:

* ``feat_err``: the forward. The program's Detect maps against the plain
  f32 reference's from the same images and weights, per image the
  relative L2 error ``|P - R| / |R|`` over all levels, the largest over
  the sampled images.
* ``post_mismatch``: decode, top-k, NMS and packing. The plain postprocess
  run on the program's own maps (upcast to f32) against the program's
  packed rows: per image, the valid rows of each side that have no row on
  the other side with the same label, a score within ``SCORE_TOL``
  (relative) and corners within ``BOX_TOL`` (of the image side), counted
  over both sides and divided by the rows of both.

The train cell's numbers are in ``drivers/train.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

#: f32 rounding of the same sums in another order moves a normalised corner
#: by ~1e-7 and a score by ~1e-7 relative; a bf16 decode moves them by ~1e-3
SCORE_TOL = 1e-5
BOX_TOL = 1e-5


def feat_err(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per image ``|P - R|_2 / |R - mean(R)|_2`` over every level's map,
    the mean taken per channel over the image's positions: (B,). The head's
    bias priors (class logits near -10) would otherwise hide the error in
    the constant part of the maps."""
    B = ref[0].shape[0]
    if len(prog) != len(ref) or any(p.shape != r.shape for p, r in zip(prog, ref)):
        return torch.full((B,), float("inf"))
    num = den = 0
    for p, r in zip(prog, ref):
        p, r = p.float().reshape(B, -1, r.shape[-1]), r.float().reshape(B, -1, r.shape[-1])
        num = num + ((p - r) ** 2).sum((1, 2))
        den = den + ((r - r.mean(1, keepdim=True)) ** 2).sum((1, 2))
    return (num.sqrt() / den.sqrt()).cpu()


def _unmatched(a: torch.Tensor, b: torch.Tensor) -> int:
    """Valid rows of ``a`` (N, 7) with no matching valid row in ``b``."""
    a, b = a[a[:, 6] > 0.5], b[b[:, 6] > 0.5]
    if len(a) == 0:
        return 0
    if len(b) == 0:
        return len(a)
    same_label = a[:, None, 5] == b[None, :, 5]
    score_ok = ((a[:, None, 4] - b[None, :, 4]).abs()
                <= SCORE_TOL * torch.maximum(a[:, None, 4].abs(), b[None, :, 4].abs()) + 1e-12)
    box_ok = ((a[:, None, :4] - b[None, :, :4]).abs() <= BOX_TOL).all(-1)
    return int((~(same_label & score_ok & box_ok).any(1)).sum())


def post_mismatch(prog: torch.Tensor, ref: torch.Tensor) -> Tuple[int, int]:
    """(unmatched rows of both sides, valid rows of both sides) over a
    batch of packed outputs (B, max_det, 7)."""
    if prog.shape != ref.shape:
        return 1, 1
    bad = rows = 0
    for p, r in zip(prog.float(), ref.float()):
        bad += _unmatched(p, r) + _unmatched(r, p)
        rows += int((p[:, 6] > 0.5).sum() + (r[:, 6] > 0.5).sum())
    return bad, max(rows, 1)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[str]]:
    """(every number within its limit, lines ``name value <= limit``). A
    number without a limit, or a limit without a number, fails."""
    ok, lines = True, []
    for name in sorted(set(numbers) | set(limits)):
        v, lim = numbers.get(name), limits.get(name)
        good = v is not None and lim is not None and v == v and v <= lim
        ok &= good
        lines.append(f"{name} {v!r} <= {lim!r} {'ok' if good else 'FAIL'}")
    return ok, lines
