"""Plan-compiler registry: scheme families as first-class backends.

The port's own copy of the JAX package's registry (the port imports
nothing of that package): a separate ``_PLAN_COMPILERS`` table, filled by
:mod:`repro_torch.core.coded_collectives` and
:mod:`repro_torch.core.resolvable`.

A *plan compiler* turns :class:`~repro_torch.core.params.SchemeParams` (plus an
optional Section-IV slot permutation) into a :class:`HybridShufflePlan` —
the static index tables that drive the executable two-stage shuffle of
:mod:`repro_torch.core.coded_collectives`.  Two families are registered:

  * ``binomial``   — the paper's Sec. III construction: per layer, the
    C(P, r) rack r-subsets each map M = (NP/K)/C(P, r) subfiles.  Multicast
    gain r, but the subfile count must satisfy C(P, r) | NP/K, which
    explodes combinatorially with P (the known Achilles' heel of CDC-style
    designs).
  * ``resolvable`` — a resolvable-design construction (Konstantinidis &
    Ramamoorthy, arXiv:1908.05666) from a single-parity-check code: the P
    racks split into r parallel classes of q = P/r, and the q^{r-1} SPC
    codewords index the subfile batches.  Multicast gain r - 1 with
    subpacketization q^{r-1} — the divisor demanded of NP/K is a plain
    prime power instead of a binomial, which is what lets K scale into the
    hundreds at practical (power-of-two) subfile counts.  See
    :mod:`repro_torch.core.resolvable` and docs/scaling.md.

All compilers emit the SAME plan schema, so every consumer (the stacked
shuffle body, the fused engine, the CUDA coded-combine path) is
family-agnostic.  Two schema extensions carry the
family-specific structure:

  * ``mcast_arity`` (the trailing dim of the ``mcast_comp_*`` tables) is
    the number of components per coded packet — r for binomial, r - 1 for
    resolvable — and replaces every hard-coded use of ``params.r`` in the
    encode/decode paths.
  * ``cross_valid`` marks which stage-1 slots of each (receiver, source)
    stream carry real data.  ``None`` (binomial) means every slot from a
    distinct rack is valid; the resolvable family pads its all_to_all
    blocks to a uniform n_send (same-class rack pairs exchange nothing),
    and the mask keeps the padding out of the layer table.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .params import SchemeParams

# Registered family names, in registration order (binomial first).
SCHEME_FAMILIES: Tuple[str, ...] = ("binomial", "resolvable")


@dataclasses.dataclass(frozen=True, eq=False)
class HybridShufflePlan:
    """Static index tables driving the executable hybrid shuffle, any r.

    Table layout is documented in :mod:`repro_torch.core.coded_collectives`
    (binomial) and :mod:`repro_torch.core.resolvable` (resolvable); the schema is
    shared — consumers dispatch on nothing but the tables themselves.
    """
    params: SchemeParams
    # global subfile ids mapped at device (rack i, layer j): [P, Kr, n_loc]
    local_subfiles: np.ndarray
    # cross-stage: local subfile positions to send to rack z: [P, Kr, P, n_send]
    cross_send_pos: np.ndarray
    # canonical layer table (global subfile id per row): [P, Kr, n_layer]
    layer_subfiles: np.ndarray
    # positions in the layer table where rack z's block lands: [P, Kr, P, n_send]
    cross_recv_pos: np.ndarray
    # layer-table rows mapped locally: [P, Kr, n_layer] bool
    local_mask: np.ndarray
    n_send: int
    # layer-table position of each locally mapped subfile: [P, Kr, n_loc]
    local_pos: np.ndarray
    # --- coded-multicast tables (the paper's f(.) on the wire) -------------
    # Packet m of sender rack i's stream to rack z combines `mcast_arity`
    # components, one per receiver rack in the multicast group; these are
    # all layer-independent (no Kr axis).  Empty ([P, P, 0, arity]) when
    # n_send = 0.
    # local position (in the sender's vals) of component c: [P,P,n_send,arity]
    mcast_comp_pos: np.ndarray
    # rack whose reduce-key block component c is destined to: [P,P,n_send,arity]
    mcast_comp_rack: np.ndarray
    # receiver side-information, receiver i <- source s: local position / key
    # rack of the arity-1 KNOWN components of each packet: [P,P,n_send,arity-1]
    mcast_known_pos: np.ndarray
    mcast_known_rack: np.ndarray
    # --- family extensions (defaults reproduce the binomial schema) --------
    family: str = "binomial"
    # stage-1 slot validity, receiver i <- source s: [P, P, n_send] bool.
    # None: every slot from s != i is valid (binomial's uniform streams).
    cross_valid: Optional[np.ndarray] = None

    @property
    def mcast_arity(self) -> int:
        """Components per coded stage-1 packet (r binomial, r-1 resolvable);
        coding degenerates to unicast when this is < 2."""
        return int(self.mcast_comp_pos.shape[-1])


# A plan compiler: (params, optional slot permutation) -> plan.  ``perm``
# places subfile perm[slot] into structural slot ``slot`` — the Section-IV
# locality degree of freedom, shared by every family.
PlanCompiler = Callable[
    [SchemeParams, Optional[Tuple[int, ...]]], HybridShufflePlan]

_PLAN_COMPILERS: Dict[str, PlanCompiler] = {}


def register_plan_compiler(family: str) -> Callable[[PlanCompiler],
                                                    PlanCompiler]:
    """Decorator registering ``fn`` as the compiler of ``family``.

    Compilers must be pure (same inputs -> bit-identical tables): the LRU
    plan cache of :mod:`repro_torch.core.coded_collectives` memoizes on
    (params, perm, family) and shares the resulting plan object.
    """
    def deco(fn: PlanCompiler) -> PlanCompiler:
        if family in _PLAN_COMPILERS:
            raise ValueError(f"plan compiler {family!r} already registered")
        _PLAN_COMPILERS[family] = fn
        return fn
    return deco


def get_plan_compiler(family: str) -> PlanCompiler:
    if family not in _PLAN_COMPILERS:
        # built-in families register on import of their host modules; pull
        # them in so a bare import of this module still resolves
        from . import coded_collectives  # noqa: F401
    try:
        return _PLAN_COMPILERS[family]
    except KeyError:
        raise ValueError(
            f"unknown scheme family {family!r}; registered: "
            f"{tuple(sorted(_PLAN_COMPILERS))}") from None


def plan_families() -> Tuple[str, ...]:
    """Registered family names, sorted."""
    return tuple(sorted(_PLAN_COMPILERS))


def scheme_of_family(family: str) -> str:
    """Sim/scheduler scheme string of a plan family ('hybrid' stays the
    binomial construction's name for back-compat)."""
    return "hybrid" if family == "binomial" else f"hybrid_{family}"


def family_of_scheme(scheme: str) -> Optional[str]:
    """Inverse of :func:`scheme_of_family`; None for non-hybrid schemes."""
    if scheme == "hybrid":
        return "binomial"
    if scheme.startswith("hybrid_"):
        return scheme[len("hybrid_"):]
    return None
