"""Pair-selection / fixing policies for global optimization.

Port of the reference's `solve/optimization_types.py` (the
`optimizationtypes/` of the Interest_Point_Registration plugin): which
view pairs get matched and which tiles are fixed, for the four
registration modes. Views are identified by (timepoint, setup_id)
ViewIds; each policy returns (pairs, fixed_views, groups) for the
pairwise matcher and `solve_global`. Plain Python: the port's own copy.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, List, Sequence, Tuple

ViewId = Tuple[int, int]


def individual_timepoint_pairs(view_ids: Sequence[ViewId]):
    """All-to-all within each timepoint, solved per timepoint
    (`IndividualTimepointRegistration`). Returns a list of
    (pairs, fixed_views, groups) — one entry per timepoint; the first view
    of each timepoint is fixed."""
    by_tp: Dict[int, List[ViewId]] = {}
    for v in sorted(view_ids):
        by_tp.setdefault(v[0], []).append(v)
    out = []
    for tp, views in sorted(by_tp.items()):
        pairs = list(combinations(views, 2))
        out.append((pairs, [views[0]], None))
    return out


def all_to_all_pairs(view_ids: Sequence[ViewId],
                     group_timepoints: bool = False):
    """All-to-all across ALL timepoints (`AllToAllRegistration`).

    If group_timepoints, views of one timepoint share a tile (move
    together), the reference's "consider each timepoint as rigid unit".
    """
    views = sorted(view_ids)
    pairs = list(combinations(views, 2))
    groups = None
    if group_timepoints:
        by_tp: Dict[int, List[ViewId]] = {}
        for v in views:
            by_tp.setdefault(v[0], []).append(v)
        groups = [vs for _tp, vs in sorted(by_tp.items())]
    return pairs, [views[0]], groups


def all_to_all_pairs_with_range(view_ids: Sequence[ViewId], tp_range: int,
                                group_timepoints: bool = False):
    """All-to-all but only between timepoints within `tp_range`
    (`AllToAllRegistrationWithRange`)."""
    views = sorted(view_ids)
    pairs = [(a, b) for a, b in combinations(views, 2)
             if abs(a[0] - b[0]) <= tp_range]
    groups = None
    if group_timepoints:
        by_tp: Dict[int, List[ViewId]] = {}
        for v in views:
            by_tp.setdefault(v[0], []).append(v)
        groups = [vs for _tp, vs in sorted(by_tp.items())]
    return pairs, [views[0]], groups


def reference_timepoint_pairs(view_ids: Sequence[ViewId],
                              reference_tp: int):
    """Each timepoint's views matched only against the reference
    timepoint's views; reference views fixed
    (`ReferenceTimepointRegistration` — timelapse stabilization)."""
    views = sorted(view_ids)
    ref_views = [v for v in views if v[0] == reference_tp]
    other = [v for v in views if v[0] != reference_tp]
    pairs = [(a, r) for a in other for r in ref_views]
    return pairs, ref_views, None
