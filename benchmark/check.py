"""The comparisons that decide ``correct``: the numbers compared and the
judgement of each against its limit.

Training (the first iterations of the very state the window then
drives, against ``reference`` run from the same weights, batches and
noise): each iteration's losses; the norm of each leaf's first gradient
as its optimizer holds it after one iteration (Adam's first moment, or
an SGD net's step over its learning rate); the norm of each leaf's
change, and of its EMA shadow's, after the last. A norm is compared by
the gap between the program's and the reference's, over the reference's
norm of that leaf or of the net's median leaf, whichever is larger; the
worst leaf counts. Leaves whose reference gradient is under a thousandth
of the median leaf's are left out of the change (they move by round-off
alone under Adam). The EMA shadow moves by a ten-thousandth of the
parameters' change a step, a few units in the last place of f32 per
element, so a leaf's shadow moves by rounding: its change is compared
over the whole net (the norm of every leaf's change together), where the
rounding averages out.

Decode: each sampled utterance's denormalised output against the
reference's, as the RMS of the gap in the target's standard deviations
over the RMS of the reference's normalised output; the worst counts.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]
SMALL_GRAD = 1e-3  # of the median leaf's reference gradient


def norms(tree: Tree) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def diff(a: Tree, b: Tree) -> Tree:
    return {k: a[k].double() - b[k].double() for k in a}


def train_norms(init: Dict[str, Tree], after1: dict, after: dict,
                hp: dict) -> dict:
    """Leaf norms of one side's first gradients and changes.
    ``after1``/``after``: ``{net: {"params", "mu", "ema"}}``."""
    grad, change = {}, {}
    for net, p0 in init.items():
        if hp[f"{net}_optimizer"] == "adam":
            grad[net] = norms(after1[net]["mu"])
        else:
            lr = hp[f"{net}_lr"]
            grad[net] = {k: v / lr for k, v in
                         norms(diff(p0, after1[net]["params"])).items()}
        change[net] = norms(diff(after[net]["params"], p0))
        change[f"{net}.ema"] = norms(diff(after[net]["ema"], p0))
    return {"grad": grad, "change": change}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    median = float(np.median([ref[k] for k in ref]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
            for k in ref if keep is None or k in keep}


def worst_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> float:
    return max(leaf_gaps(prog, ref, keep).values(), default=0.0)


def whole(leaf_norms: Dict[str, float]) -> float:
    """The norm of every leaf together."""
    return math.sqrt(sum(v * v for v in leaf_norms.values()))


def worst_leaves(prog: dict, ref: dict) -> Dict[str, list]:
    """Per part of ``train_norms``, the worst leaf and its gap (to look
    at where a number comes from)."""
    out = {}
    for kind in ("grad", "change"):
        for part in ref[kind]:
            gaps = leaf_gaps(prog[kind][part], ref[kind][part])
            name = max(gaps, key=gaps.get)
            out[f"{kind}:{part}"] = [name, gaps[name]]
    return out


def training_numbers(prog_losses: List[dict], prog: dict,
                     ref_losses: List[dict], ref: dict) -> dict:
    """``prog``/``ref``: ``train_norms`` of each side."""
    loss_gap = 0.0
    for p, r in zip(prog_losses, ref_losses):
        for k, rv in r.items():
            if rv == 0.0 and p[k] == 0.0:
                continue
            loss_gap = max(loss_gap, abs(p[k] - rv) / max(abs(rv), 1e-30))
    grad_gap = max(worst_gap(prog["grad"][n], ref["grad"][n])
                   for n in ref["grad"])
    change_gap = ema_gap = 0.0
    for n, ref_grads in ref["grad"].items():
        median = float(np.median(list(ref_grads.values())))
        keep = {k for k, v in ref_grads.items() if v >= SMALL_GRAD * median}
        change_gap = max(change_gap, worst_gap(
            prog["change"][n], ref["change"][n], keep))
        p, r = (whole({k: v for k, v in side["change"][f"{n}.ema"].items()
                       if k in keep}) for side in (prog, ref))
        ema_gap = max(ema_gap, abs(p - r) / max(r, 1e-30))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "ema_gap": ema_gap}


def decode_gap(prog: np.ndarray, ref: np.ndarray, mean: np.ndarray,
               std: np.ndarray) -> float:
    """One utterance: RMS((prog - ref) / std) / RMS((ref - mean) / std)."""
    err = (np.asarray(prog, np.float64) - ref) / std
    scale = (np.asarray(ref, np.float64) - mean) / std
    return float(np.sqrt(np.mean(err * err)) / np.sqrt(np.mean(
        scale * scale)))


def judge(numbers: Dict[str, float],
          limits: Dict[str, Optional[float]]) -> List[dict]:
    """Each number beside its limit; a number passes when it is finite
    and at most its limit (a number with no limit fails)."""
    out = []
    for name in sorted(limits):
        value = numbers.get(name, math.nan)
        limit = limits[name]
        ok = (limit is not None and math.isfinite(value)
              and value <= limit)
        out.append({"name": name, "value": value, "limit": limit,
                    "ok": ok})
    return out
