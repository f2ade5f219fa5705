"""The comparison that decides ``correct``: the numbers, each beside its
limit from ``limits/<workload>.json``.

Prefill (``token_gap``, ``logit_err``, ``row_gap``; a cell's ``compare``
names those it compares, by default the first two): at the sampled
positions of the sampled rows, the program's greedy token (the argmax of
its logits, as the first token is served) is looked up in the
reference's f32 logits; ``token_gap`` is the ``token_gap_q`` quantile
(1: the widest) of the gaps by which such a token's reference logit lies
below the reference's best. ``row_gap`` is the largest over the rows of
the median of a row's gaps, which one wrong row shows whatever the other
rows read. ``logit_err`` is the largest over the positions of
‖program − reference‖ / ‖reference − its mean‖ over the vocabulary.

Training (``loss_gap``, ``grad_gap``, ``delta_gap``): each checked step's
loss, the leaf norms of the first clipped gradient and of the change of
the parameters after the checked steps, each a relative gap by the worst
leaf: |program − reference| over the larger of the reference's leaf norm
and its median leaf's. Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of the change.
"""
from __future__ import annotations

import statistics
from typing import Any, Dict, List, Tuple

import torch


def _quantile(x: torch.Tensor, q: float) -> float:
    if q >= 1.0:
        return float(x.max())
    return float(torch.quantile(x.double(), q))


def prefill_numbers(prog: torch.Tensor, ref: torch.Tensor,
                    limits: Dict[str, Any], rows: List[int]
                    ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(numbers, diagnostics) of the program's logits ``prog`` [n,V]
    against the reference's ``ref`` [n,V] at the same positions, ``rows``
    the number of positions of each row, in order."""
    prog, ref = prog.float(), ref.float()
    served = prog.argmax(-1)
    gap = ref.max(-1).values - ref.gather(1, served[:, None])[:, 0]
    centred = ref - ref.mean(-1, keepdim=True)
    err = (prog - ref).norm(dim=-1) / centred.norm(dim=-1)
    row_medians = [float(g.median()) for g in gap.split(rows)]
    numbers = {"token_gap": _quantile(gap,
                                      float(limits.get("token_gap_q", 1.0))),
               "logit_err": float(err.max()),
               "row_gap": max(row_medians)}
    diag = {"positions": float(ref.shape[0]), "numbers": dict(numbers),
            "agree_top1": float((served == ref.argmax(-1)).float().mean()),
            "logit_err_median": _quantile(err, 0.5),
            "token_gap_max": float(gap.max())}
    names = limits.get("compare", ["token_gap", "logit_err"])
    return {k: numbers[k] for k in names}, diag


def _worst_leaf(prog: List[float], ref: List[float],
                use: List[bool]) -> Tuple[float, int]:
    med = statistics.median([r for r, u in zip(ref, use) if u])
    worst, at = 0.0, -1
    for i, (p, r, u) in enumerate(zip(prog, ref, use)):
        if not u:
            continue
        gap = abs(p - r) / max(r, med)
        if gap > worst:
            worst, at = gap, i
    return worst, at


def train_numbers(prog: Dict[str, Any], ref: Dict[str, Any]
                  ) -> Tuple[Dict[str, float], Dict[str, Any]]:
    """(numbers, diagnostics) of the program's checked steps against the
    reference's (``reference.model.train_steps``)."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                         ref["loss"]))
    g_ref = ref["grad_norm"]
    med = statistics.median(g_ref)
    moving = [g >= 1e-3 * med for g in g_ref]
    grad_gap, g_at = _worst_leaf(prog["grad_norm"], g_ref,
                                 [True] * len(g_ref))
    delta_gap, d_at = _worst_leaf(prog["delta_norm"], ref["delta_norm"],
                                  moving)
    paths = ref["paths"]
    diag = {"loss_program": prog["loss"], "loss_reference": ref["loss"],
            "grad_worst_leaf": "/".join(map(str, paths[g_at])),
            "delta_worst_leaf": "/".join(map(str, paths[d_at])),
            "leaves_left_out": sum(not m for m in moving)}
    return ({"loss_gap": loss_gap, "grad_gap": grad_gap,
             "delta_gap": delta_gap}, diag)


def judge(numbers: Dict[str, float], limits: Dict[str, Any]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number within its limit, ``{name: {value, limit}}``)."""
    checks = {k: {"value": v, "limit": float(limits[k])}
              for k, v in numbers.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
