"""Job-arrival generators over the MapReduce job zoo.

A workload is a deterministic (seeded) stream of :class:`JobSpec` — the
paper's single-job analysis extended to the multi-job regime the ROADMAP
targets: heterogeneous sizes, Poisson / bursty / diurnal arrival processes.
Job kinds reference the executable zoo of :mod:`repro_torch.mapreduce.jobs`
(name and payload width d match the real jobs, so a simulated stream can be
replayed against the engine).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np

# (name, payload width d) of the executable job zoo
# (repro_torch.mapreduce.jobs)
JOB_ZOO: Tuple[Tuple[str, int], ...] = (
    ("histogram", 1),
    ("groupby_mean", 2),
    ("terasort_bucket", 8),
    ("wide_histogram_d16", 16),
)


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One job of the stream: an executable-zoo kind plus its size knobs."""
    name: str
    N: int                 # subfiles
    Q: int                 # reduce keys
    d: int                 # payload width per (key, subfile)
    arrival: float = 0.0   # arrival time, seconds

    @property
    def total_pairs(self) -> float:
        """Total intermediate value-units (N * Q * d) — the size proxy used
        by SRPT ordering."""
        return float(self.N) * self.Q * self.d


SCHEME_FAMILY_NAMES = ("binomial", "resolvable")


def valid_subfile_counts(K: int, P: int, rs: Sequence[int],
                         base: int = 1, count: int = 4,
                         coded_rs: Sequence[int] = (),
                         families: Sequence[str] = ("binomial",)
                         ) -> List[int]:
    """Admissible subfile counts per scheme family, deduped and sorted.

    For each family in ``families``, finds the minimal N satisfying the
    family's divisibility hypotheses for EVERY r in ``rs`` — binomial: K|NP,
    C(P,r) | NP/K and r | M; resolvable: q^{r-1} | NP/K and (r-1) | M with
    q = P/r (rs entries structurally outside the family, e.g. r = 1 or
    r ∤ P, do not constrain it — the chooser drops those candidates the
    same way) — plus K | N (uncoded) and Coded MapReduce's C(K,r) | N for
    every r in ``coded_rs``.  Emits the smallest ``count`` multiples of each
    family's minimum and returns the sorted union, so workload generators
    produce jobs feasible for every requested family."""
    if any(r > P for r in rs):
        raise ValueError(f"hybrid requires r <= P; got rs={tuple(rs)} P={P}")
    unknown = set(families) - set(SCHEME_FAMILY_NAMES)
    if unknown:
        raise ValueError(f"unknown scheme families {sorted(unknown)}; "
                         f"known: {SCHEME_FAMILY_NAMES}")

    def ok_common(n: int) -> bool:
        if (n * P) % K or n % K:
            return False
        return all(n % math.comb(K, r) == 0 for r in coded_rs)

    def ok_family(n: int, family: str) -> bool:
        per_layer = n * P // K
        for r in rs:
            if family == "binomial":
                c = math.comb(P, r)
                if per_layer % c or (per_layer // c) % r:
                    return False
            else:                                  # resolvable
                if r < 2 or P % r or P // r < 2:
                    continue    # structurally outside the family's range
                b = (P // r) ** (r - 1)
                if per_layer % b or (per_layer // b) % (r - 1):
                    return False
        return True

    out = set()
    for family in dict.fromkeys(families):         # preserve, dedupe
        n0 = next(n for n in range(1, 10 ** 7)
                  if ok_common(n) and ok_family(n, family))
        out.update(n0 * base * m for m in range(1, count + 1))
    return sorted(out)


class Workload:
    """Base: subclasses implement arrival-time generation; sizes and kinds
    are drawn i.i.d. from a catalog of (name, N, Q, d) tuples."""

    def __init__(self, catalog: Sequence[Tuple[str, int, int, int]],
                 n_jobs: int) -> None:
        if not catalog:
            raise ValueError("catalog must be non-empty")
        self.catalog = list(catalog)
        self.n_jobs = int(n_jobs)

    def _arrival_times(self, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    def generate(self, seed: int = 0) -> List[JobSpec]:
        rng = np.random.default_rng(seed)
        times = np.sort(self._arrival_times(rng))[: self.n_jobs]
        picks = rng.integers(0, len(self.catalog), size=len(times))
        jobs = []
        for t, k in zip(times, picks):
            name, N, Q, d = self.catalog[int(k)]
            jobs.append(JobSpec(name, N, Q, d, float(t)))
        return jobs


class PoissonWorkload(Workload):
    """Memoryless arrivals at ``rate`` jobs/s — the M/G/K baseline."""

    def __init__(self, catalog, n_jobs: int, rate: float) -> None:
        super().__init__(catalog, n_jobs)
        if rate <= 0:
            raise ValueError("rate must be positive")
        self.rate = float(rate)

    def _arrival_times(self, rng: np.random.Generator) -> np.ndarray:
        gaps = rng.exponential(1.0 / self.rate, size=self.n_jobs)
        return np.cumsum(gaps)


class BurstyWorkload(Workload):
    """Batches of ``burst_size`` simultaneous jobs every ``burst_gap``
    seconds (synchronized pipelines / cron storms): the worst case for
    cross-rack contention."""

    def __init__(self, catalog, n_jobs: int, burst_size: int = 4,
                 burst_gap: float = 1.0) -> None:
        super().__init__(catalog, n_jobs)
        if burst_size < 1 or burst_gap <= 0:
            raise ValueError("need burst_size >= 1 and burst_gap > 0")
        self.burst_size = int(burst_size)
        self.burst_gap = float(burst_gap)

    def _arrival_times(self, rng: np.random.Generator) -> np.ndarray:
        n_bursts = -(-self.n_jobs // self.burst_size)
        t = np.repeat(np.arange(n_bursts) * self.burst_gap, self.burst_size)
        return t[: self.n_jobs]


class DiurnalWorkload(Workload):
    """Non-homogeneous Poisson process whose rate follows a day/night
    sinusoid between ``base_rate`` and ``peak_rate`` with period ``period``
    (thinning construction — exact and deterministic per seed)."""

    def __init__(self, catalog, n_jobs: int, base_rate: float,
                 peak_rate: float, period: float = 86400.0) -> None:
        super().__init__(catalog, n_jobs)
        if not 0 < base_rate <= peak_rate:
            raise ValueError("need 0 < base_rate <= peak_rate")
        self.base_rate = float(base_rate)
        self.peak_rate = float(peak_rate)
        self.period = float(period)

    def _rate(self, t: np.ndarray) -> np.ndarray:
        mid = (self.base_rate + self.peak_rate) / 2.0
        amp = (self.peak_rate - self.base_rate) / 2.0
        return mid + amp * np.sin(2.0 * np.pi * t / self.period)

    def _arrival_times(self, rng: np.random.Generator) -> np.ndarray:
        times: List[float] = []
        t = 0.0
        while len(times) < self.n_jobs:
            t += float(rng.exponential(1.0 / self.peak_rate))
            if rng.random() < self._rate(np.asarray(t)) / self.peak_rate:
                times.append(t)
        return np.asarray(times)


def default_catalog(K: int, P: int, rs: Sequence[int] = (1, 2, 3),
                    q_mult: int = 2,
                    coded_rs: Sequence[int] = (2,),
                    families: Sequence[str] = ("binomial",)
                    ) -> List[Tuple[str, int, int, int]]:
    """Heterogeneous (name, N, Q, d) catalog: every zoo kind at a distinct
    valid size, Q = q_mult * K keys.  Sizes admit every hybrid r in ``rs``
    for every scheme family in ``families`` AND Coded MapReduce at
    ``coded_rs`` (so fixed-scheme baselines are well-defined on the whole
    stream)."""
    sizes = valid_subfile_counts(K, P, rs, count=len(JOB_ZOO),
                                 coded_rs=coded_rs, families=families)
    return [(name, n, q_mult * K, d)
            for (name, d), n in zip(JOB_ZOO, sizes)]
