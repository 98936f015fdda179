"""Closed-form communication costs (Propositions 1-2, Theorem III.1, Cor III.2).

All costs are counted in <key, value> pair transfers, exactly as in the paper.
``intra`` = pairs through a Top-of-Rack switch, ``cro`` = pairs through the
root switch.  A coded multicast counts ONCE regardless of receiver count.
"""
from __future__ import annotations

import dataclasses
from math import comb, e
from typing import Dict

from .params import SchemeParams


@dataclasses.dataclass(frozen=True)
class CommCost:
    intra: float
    cross: float

    @property
    def total(self) -> float:
        return self.intra + self.cross

    def weighted_time(self, intra_bw: float, cross_bw: float) -> float:
        """Shuffle time proxy: pairs / bandwidth per tier (cross is the
        bottleneck tier in a server-rack network; intra transfers of distinct
        racks run in parallel, hence the per-rack divisor)."""
        return self.cross / cross_bw + self.intra / intra_bw


def uncoded_cost(p: SchemeParams, check: bool = True) -> CommCost:
    """Proposition 1."""
    if check:
        p.validate_uncoded()
    intra = p.Q * p.N * (1.0 / p.P - 1.0 / p.K)
    cross = p.Q * p.N * (1.0 - 1.0 / p.P)
    return CommCost(intra, cross)


def coded_cost(p: SchemeParams, check: bool = True) -> CommCost:
    """Proposition 2."""
    if check:
        p.validate_coded()
    total = p.Q * p.N / p.r * (1.0 - p.r / p.K)
    if p.Kr >= p.r + 1:
        frac_intra = p.P * comb(p.Kr, p.r + 1) / comb(p.K, p.r + 1)
    else:
        frac_intra = 0.0
    return CommCost(total * frac_intra, total * (1.0 - frac_intra))


def hybrid_cost(p: SchemeParams, check: bool = True) -> CommCost:
    """Theorem III.1.

    Note: paper Table I row (20,4,20,380,2) violates the theorem's own
    divisibility hypothesis C(P,r)|(NP/K) (=76/6); pass ``check=False`` to
    evaluate the closed form anyway, as the paper implicitly did.
    """
    if check:
        p.validate_hybrid()
    cross = p.Q * p.N / p.r * (1.0 - p.r / p.P)
    intra = p.Q * p.N * (1.0 - p.P / p.K)
    return CommCost(intra, cross)


def hybrid_resolvable_cost(p: SchemeParams, check: bool = True) -> CommCost:
    """Resolvable-design hybrid (repro_torch.core.resolvable): multicast gain r-1
    instead of r, identical intra-rack stage.  Derivation: per layer the
    q^{r-1}(q-1) non-codeword groups each carry r senders' M/(r-1)-row
    packet streams of Q/P keys, each traversing the root once; summed over
    Kr layers this telescopes to QN/(r-1) * (1 - r/P).  Proven against the
    enumerated message schedule in tests/test_resolvable.py."""
    if check:
        p.validate_hybrid_resolvable()
    cross = p.Q * p.N / (p.r - 1) * (1.0 - p.r / p.P)
    intra = p.Q * p.N * (1.0 - p.P / p.K)
    return CommCost(intra, cross)


def cost_table(p: SchemeParams, check: bool = True) -> Dict[str, CommCost]:
    return {
        "uncoded": uncoded_cost(p, check),
        "coded": coded_cost(p, check),
        "hybrid": hybrid_cost(p, check),
    }


# -- Corollary III.2 bounds ---------------------------------------------------

def corollary_bounds(p: SchemeParams) -> Dict[str, float]:
    """Bounds of Corollary III.2 (sanity-checked against exact ratios)."""
    cod, hyb = coded_cost(p), hybrid_cost(p)
    lower_cross_ratio = ((1.0 - p.r / p.K) / (1.0 - p.r / p.P)
                         * (1.0 - e ** (p.r + 1) / p.P ** p.r))
    upper_intra_ratio = (p.r * (p.K - p.P) / (p.K - p.r)
                         * e ** (p.r + 1) * p.P ** p.r)
    out = {
        "cross_ratio_exact": cod.cross / hyb.cross if hyb.cross else float("inf"),
        "cross_ratio_lower_bound": lower_cross_ratio,
        "intra_ratio_exact": hyb.intra / cod.intra if cod.intra else float("inf"),
        "intra_ratio_upper_bound": upper_intra_ratio,
    }
    return out
