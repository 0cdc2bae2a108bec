"""The comparison that decides ``correct``: numbers of the program's outputs
against the plain reference's, each held to the limit the cell's file gives.

Detections (every field of every candidate, after NMS):

- ``box_gap``: the largest |box difference| over the largest |reference box value|;
- ``score_gap``: the largest |score difference| over the largest |reference score|;
- ``class_gap``: the widest gap by which the reference's value of the class
  the program chose lies below the reference's best class value of that
  candidate, over the largest |reference class value| (a near tie may go
  either way; a wrong class may not);
- ``keep_flips``: the share of candidates kept by one side only.

Training (the program's first steps against the reference's, from the same
weights and batches; worst leaf, gap of norms over the larger of the leaf's
reference norm and the median leaf's):

- ``loss_gap``: |loss difference| / |reference loss| of the first step;
- ``grad_gap``: the first step's update gradient (as Adam receives it), worst leaf;
- ``update_gap``: the change of the parameters over the checked steps, worst
  leaf, over leaves whose reference gradient is at least 1e-3 of the median
  leaf's; ``update_gap_median``: the median of those leaves' |gap of norms| /
  their reference norm.

The later steps' losses are not held to a limit: in bf16 the two sides'
roundings part after the first update, and those losses swing from seed to
seed (PERF.md, Findings).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def _cpu(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().cpu()


def detections(prog: Sequence, ref: Sequence) -> Dict[str, float]:
    """``prog``: (boxes, scores, class_ids, valid) of some images; ``ref``:
    the same fields and the class values (``references.detect.Dets``)."""
    pb, ps, pc, pv = (_cpu(t) for t in prog[:4])
    rb, rs, rc, rv, rv_cls = (_cpu(t) for t in ref[:5])
    if pb.shape != rb.shape:
        raise ValueError(f"program boxes {tuple(pb.shape)} vs reference {tuple(rb.shape)}")

    def gap(a, b):
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    cls = rv_cls.double()
    chosen = pc.long()
    if bool(((chosen < 0) | (chosen >= cls.shape[-1])).any()):
        class_gap = float("inf")
    else:
        below = cls.amax(dim=-1) - cls.gather(-1, chosen[..., None]).squeeze(-1)
        class_gap = float(below.max() / cls.abs().max().clamp(min=1e-30))
    return {"box_gap": gap(pb, rb), "score_gap": gap(ps, rs), "class_gap": class_gap,
            "keep_flips": float((pv.bool() != rv.bool()).double().mean())}


def worst_of(worst: Dict[str, float], new: Dict[str, float]) -> Dict[str, float]:
    """``worst`` updated in place to the larger reading of each number; NaN wins."""
    for k, v in new.items():
        old = worst.get(k)
        if old is None or v != v or v > old:
            worst[k] = v
    return worst


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], names=None) -> float:
    """max over leaves of |norm_prog - norm_ref| / max(norm_ref, median norm_ref)."""
    names = list(ref) if names is None else list(names)
    med = float(torch.tensor([ref[n] for n in ref]).median())
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def counted_leaves(ref_grad: Dict[str, float], share: float = 1e-3):
    """Leaves whose reference gradient norm is at least ``share`` of the
    median leaf's (the others move under Adam by rounding alone)."""
    med = float(torch.tensor(list(ref_grad.values())).median())
    return [n for n, v in ref_grad.items() if v >= share * med]


def training(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog``/``ref``: {"losses": [...], "grad": {leaf: norm}, "update": {leaf: norm}}.

    The numbers the check holds to limits: ``loss_gap`` (the first step's),
    ``grad_gap`` (worst leaf), ``update_gap`` (worst counted leaf of the
    change over the checked steps) and ``update_gap_median``."""
    counted = counted_leaves(ref["grad"])
    gaps = sorted(abs(prog["update"][n] - ref["update"][n]) / max(ref["update"][n], 1e-30)
                  for n in counted)
    return {"loss_gap": abs(prog["losses"][0] - ref["losses"][0]) / max(abs(ref["losses"][0]),
                                                                      1e-30),
            "grad_gap": worst_leaf(prog["grad"], ref["grad"]),
            "update_gap": worst_leaf(prog["update"], ref["update"], counted),
            "update_gap_median": float(gaps[len(gaps) // 2]) if gaps else float("nan")}


def step_loss_gaps(prog: Dict, ref: Dict) -> list:
    """Each checked step's |loss difference| / |reference loss|."""
    return [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
