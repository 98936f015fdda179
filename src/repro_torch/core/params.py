"""Scheme parameters for (Hybrid) Coded MapReduce on a server-rack cluster.

Notation follows the paper (Gupta & Lalitha, 2017):
  K  — number of servers in the cluster
  P  — number of racks                  (P | K)
  Kr — servers per rack, Kr = K / P
  N  — number of subfiles of the job
  Q  — number of keys to reduce         (K | Q)
  r  — Map-task replication factor
  M  — subfiles per (layer, rack r-subset) slot in the hybrid scheme,
       M = (N P / K) / C(P, r)
  r_f — file (storage) replication factor, used only by the locality
       optimizer of Section IV (HDFS-style replica placement).

Server indexing: the paper writes S_{ij} with rack 1<=i<=P and in-rack slot
1<=j<=Kr.  We use 0-based flat ids  s = rack * Kr + slot,  and call the set
{S_{1j},...,S_{Pj}} (fixed slot j across racks) a *layer*.
"""
from __future__ import annotations

import dataclasses
from math import comb


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class SchemeParams:
    """Parameters of a MapReduce job on a server-rack cluster."""

    K: int          # servers
    P: int          # racks
    Q: int          # keys
    N: int          # subfiles
    r: int = 2      # map replication factor
    r_f: int = 3    # file replication (locality optimizer only)

    def __post_init__(self) -> None:
        _check(self.K >= 1 and self.P >= 1 and self.Q >= 1 and self.N >= 1,
               "K, P, Q, N must be positive")
        _check(self.K % self.P == 0, f"P={self.P} must divide K={self.K}")
        _check(1 <= self.r, f"replication r={self.r} must be >= 1")
        _check(self.r_f >= 1, "r_f must be >= 1")

    # ---- derived quantities -------------------------------------------------

    @property
    def Kr(self) -> int:
        """Servers per rack."""
        return self.K // self.P

    @property
    def n_layers(self) -> int:
        """Number of server layers (= Kr)."""
        return self.Kr

    @property
    def subfiles_per_layer(self) -> int:
        """N P / K subfiles per layer in the hybrid scheme."""
        return self.N * self.P // self.K

    @property
    def M(self) -> int:
        """Subfiles per (layer, rack r-subset) slot: (NP/K) / C(P, r)."""
        return self.subfiles_per_layer // comb(self.P, self.r)

    @property
    def J(self) -> int:
        """Coded MapReduce: subfiles per server r-subset, N / C(K, r)."""
        return self.N // comb(self.K, self.r)

    # ---- resolvable-family derived quantities ------------------------------

    @property
    def spc_q(self) -> int:
        """Racks per parallel class of the resolvable family, q = P / r."""
        return self.P // self.r

    @property
    def spc_batches(self) -> int:
        """Subfile batches per layer of the resolvable family: the q^{r-1}
        codewords of the (r, r-1) single-parity-check code over Z_q."""
        return self.spc_q ** (self.r - 1)

    @property
    def M_res(self) -> int:
        """Resolvable family: subfiles per (layer, batch), (NP/K)/q^{r-1}."""
        return self.subfiles_per_layer // self.spc_batches

    # ---- per-scheme divisibility checks ------------------------------------

    def validate_uncoded(self) -> None:
        _check(self.N % self.K == 0, f"uncoded needs K|N; K={self.K} N={self.N}")
        _check(self.Q % self.K == 0, f"uncoded needs K|Q; K={self.K} Q={self.Q}")

    def validate_coded(self) -> None:
        c = comb(self.K, self.r)
        _check(self.N % c == 0,
               f"coded needs C(K,r)|N; C({self.K},{self.r})={c} N={self.N}")
        _check(self.Q % self.K == 0, f"coded needs K|Q; K={self.K} Q={self.Q}")
        _check(self.r < self.K, "coded needs r < K")

    def validate_hybrid(self) -> None:
        _check(self.r <= self.P, f"hybrid needs r <= P; r={self.r} P={self.P}")
        _check(self.N * self.P % self.K == 0,
               f"hybrid needs K | N*P; K={self.K} N={self.N} P={self.P}")
        c = comb(self.P, self.r)
        _check(self.subfiles_per_layer % c == 0,
               f"hybrid needs C(P,r)|(NP/K); C({self.P},{self.r})={c} "
               f"NP/K={self.subfiles_per_layer}")
        _check(self.Q % self.K == 0, f"hybrid needs K|Q; K={self.K} Q={self.Q}")

    def validate_hybrid_resolvable(self) -> None:
        """Resolvable-design family (see repro_torch.core.resolvable): needs r >= 2
        parallel classes of q = P/r >= 2 racks, q^{r-1} | NP/K subfile
        batches, and r-1 shares per missing batch."""
        _check(self.r >= 2,
               f"resolvable needs r >= 2; r={self.r}")
        _check(self.P % self.r == 0,
               f"resolvable needs r|P; r={self.r} P={self.P}")
        _check(self.spc_q >= 2,
               f"resolvable needs q=P/r >= 2; P={self.P} r={self.r}")
        _check(self.N * self.P % self.K == 0,
               f"resolvable needs K | N*P; K={self.K} N={self.N} P={self.P}")
        b = self.spc_batches
        _check(self.subfiles_per_layer % b == 0,
               f"resolvable needs q^(r-1)|(NP/K); q^(r-1)={b} "
               f"NP/K={self.subfiles_per_layer}")
        _check(self.M_res % (self.r - 1) == 0,
               f"resolvable needs (r-1)|M; M={self.M_res} r={self.r}")
        _check(self.Q % self.K == 0,
               f"resolvable needs K|Q; K={self.K} Q={self.Q}")

    # ---- topology helpers ---------------------------------------------------

    def rack_of(self, server: int) -> int:
        """Rack index of a flat server id."""
        return server // self.Kr

    def slot_of(self, server: int) -> int:
        """In-rack slot (== layer) of a flat server id."""
        return server % self.Kr

    def server_id(self, rack: int, slot: int) -> int:
        return rack * self.Kr + slot

    def keys_of_server(self, server: int) -> range:
        """The paper assigns Q/K contiguous keys to each server."""
        per = self.Q // self.K
        return range(server * per, (server + 1) * per)

    def server_of_key(self, key: int) -> int:
        return key // (self.Q // self.K)

    def rack_of_key(self, key: int) -> int:
        return self.rack_of(self.server_of_key(key))

    def keys_of_rack(self, rack: int) -> range:
        per = self.Q // self.P
        return range(rack * per, (rack + 1) * per)


# The paper's Table I grid: (K, P, Q, N, r) of its nine experiment rows.
# Single source of truth for every bench/experiment that sweeps the grid
# (benchmarks/table1_costs.py, benchmarks/sim_bench.py,
# repro.resilience.experiments); three rows violate C(P,r) | NP/K and are
# evaluated with check=False, exactly as the paper implicitly did.
TABLE1_GRID = (
    (9, 3, 18, 72, 2),
    (16, 4, 16, 240, 2),
    (16, 4, 16, 1680, 3),
    (15, 3, 15, 210, 2),
    (20, 4, 20, 380, 2),
    (25, 5, 25, 600, 2),
    (25, 5, 25, 6900, 3),
    (30, 5, 30, 870, 2),
    (30, 6, 30, 870, 2),
)
