"""Security analysis calculators (paper §4.2), computed in log space.

The paper's probabilities (e.g. ``2^{-9×10^6}``) underflow any float format, so
every quantity is reported as ``log2 p`` / ``log10 p``.  The formulas:

* Brute-force attack on ``M``  (Theorem 1):
      P_{M,bf} <= 1/2 * sigma^(N-1),   N = (alpha m^2 / kappa)^2
* Brute-force attack on ``rand``:
      P_{r,bf} = 1 / beta!
* Aug-Conv reversing attack (eq. 14):
      P_{M,ar} <= 1/2 * sigma^(N_ar - 1),
      N_ar = (alpha m^2/kappa - n^2) * (alpha m^2/kappa) + alpha beta p^2
* Minimal-cost setting (eq. 13):  kappa_mc = alpha m^2 / n^2
* D-T pair attack (SHBC): requires q = alpha m^2 / kappa pairs.

Verified against every number quoted in the paper (tests/test_security.py):
CIFAR+VGG-16 (alpha=3, m=32, n=32, p=3, beta=64, kappa=1, sigma=0.5):
  P_{M,bf} ~ 2^-3072^2,  P_{r,bf} = 1/64! ~ 7.9e-90,
  P_{M,ar} ~ 2^-(3072*2048), MC: P_{M,ar} ~ 2^-1728, D-T pairs = 3072.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = [
    "MoLeSecurity",
    "log2_p_m_bruteforce",
    "log10_p_rand_bruteforce",
    "log2_p_augconv_reversing",
    "kappa_mc",
    "dt_pairs_required",
    "analyze",
]


def log2_p_m_bruteforce(sigma: float, alpha: int, m: int, kappa: int) -> float:
    """log2 of Theorem-1 upper bound.  sigma = privacy reservation R_p."""
    if not 0.0 < sigma < 1.0:
        raise ValueError("sigma must be in (0, 1)")
    n_elems = (alpha * m * m // kappa) ** 2
    return -1.0 + (n_elems - 1) * math.log2(sigma)


def log10_p_rand_bruteforce(beta: int) -> float:
    """log10(1/beta!) via lgamma."""
    return -math.lgamma(beta + 1) / math.log(10.0)


def log2_p_augconv_reversing(
    sigma: float, alpha: int, m: int, n: int, p: int, beta: int, kappa: int
) -> float:
    """log2 of the eq.-14 upper bound."""
    rows = alpha * m * m // kappa
    n_elems = (rows - n * n) * rows + alpha * beta * p * p
    n_elems = max(n_elems, 1)
    return -1.0 + (n_elems - 1) * math.log2(sigma)


def kappa_mc(alpha: int, m: int, n: int) -> int:
    """Largest kappa that still resists Aug-Conv reversing (eq. 13)."""
    return (alpha * m * m) // (n * n)


def dt_pairs_required(alpha: int, m: int, kappa: int) -> int:
    """SHBC D-T pair attack: number of pairs to solve eq. 15 = rows of M'."""
    return alpha * m * m // kappa


@dataclasses.dataclass(frozen=True)
class MoLeSecurity:
    """Full security report for one layer geometry + morphing setting."""

    sigma: float
    alpha: int
    beta: int
    m: int
    n: int
    p: int
    kappa: int
    log2_p_m_bf: float
    log10_p_r_bf: float
    log2_p_m_ar: float
    kappa_mc: int
    dt_pairs: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def analyze(
    *, sigma: float, alpha: int, beta: int, m: int, n: int, p: int, kappa: int
) -> MoLeSecurity:
    return MoLeSecurity(
        sigma=sigma,
        alpha=alpha,
        beta=beta,
        m=m,
        n=n,
        p=p,
        kappa=kappa,
        log2_p_m_bf=log2_p_m_bruteforce(sigma, alpha, m, kappa),
        log10_p_r_bf=log10_p_rand_bruteforce(beta),
        log2_p_m_ar=log2_p_augconv_reversing(sigma, alpha, m, n, p, beta, kappa),
        kappa_mc=kappa_mc(alpha, m, n),
        dt_pairs=dt_pairs_required(alpha, m, kappa),
    )


def vocab_perm_log10_p(vocab: int) -> float:
    """Discrete (token-LM) analogue: brute force on a secret vocab permutation.

    log10(1/V!).  NOTE (DESIGN.md §4): a vocabulary permutation is a
    substitution cipher — this bound holds only against blind brute force; a
    frequency-analysis adversary does far better.  See
    benchmarks/security_table.py for the quantified demonstration.
    """
    return -math.lgamma(vocab + 1) / math.log(10.0)
