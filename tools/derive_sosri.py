"""Derive stability-optimized SRI tableaus (SOSRI-opt / SOSRI2-opt).

The reference integrates neural SDEs with StochasticDiffEq's SOSRI /
SOSRI2 (reference: src/models/neural_sde.jl:54-55,
experiments/mnist_nsde.jl:45-65) — 4-stage diagonal-noise SRI methods
whose free coefficients were numerically optimized for stability
(Rackauckas & Nie, "Stability-optimized high order methods and stiffness
detection for pathwise stiff stochastic differential equations"). The
upstream constants are not re-derivable bit-for-bit without that source,
so this script performs the same *procedure* from scratch:

1. Fix the diffusion (H1/beta) side to Rößler's SRIW1 values — they
   already satisfy every diffusion-only strong-1.5 order condition
   (verified numerically via ``sri.order_condition_residuals``).
2. Free the drift side: chained stages A0 (lower-tri), drift-noise
   coupling B0 (column 1), weights alpha; stage times c0 = A0 row sums.
3. Enforce the drift-side order conditions
       sum(alpha) = 1,   alpha.A0e = 1/2        (deterministic order 2)
       alpha.B0e  = 1,   alpha.(B0e)^2 = 3/2    (f'g I(1,0) coupling)
4. Maximize the negative-real-axis deterministic stability interval of
   R(z) = 1 + z + z^2/2 + r3 z^3 + r4 z^4 (r3, r4 free through A0/alpha),
   with an interior damping band |R| <= damping to keep a robust region
   off-axis (SOSRI2 uses a stronger band; its stability size feeds the
   stiff_est regularizer normalization).
5. Place the B0 mass by minimum-norm solve of the two B0 constraints
   (small drift-noise coupling perturbs the drift stability least).

Phase-1 optimum is found on (r3, r4) directly; phase 2 realizes it as a
tableau. Validation (tests/test_sri.py): order-condition residuals ~ 0,
deterministic order-2 convergence, strong order ~1.5 self-convergence on
GBM with exactly aggregated (dW, I10) refinements, and stability sizes.

Run:  python tools/derive_sosri.py
Prints the tableau literals pasted into regneuralde_tpu/ops/sri.py.
"""

import sys
from pathlib import Path

import numpy as np
from scipy import optimize

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from regneuralde_tpu.ops import sri  # noqa: E402


def real_axis_size(coeffs, damping=1.0, n=8192, xmax=40.0):
    """Largest L with |R(-x)| <= 1 on (0, L] and additionally
    |R(-x)| <= damping on [1, L] (an interior damping band — near the
    origin R ~ 1 - x necessarily, so the band only binds away from 0)."""
    xs = np.linspace(0.0, xmax, n + 1)[1:]
    vals = np.abs(np.polyval(coeffs[::-1], -xs))
    thr = np.where(xs >= 1.0, damping, 1.0)
    bad = np.nonzero(vals > thr)[0]
    if len(bad) == 0:
        return xmax
    if bad[0] == 0:
        return 0.0
    return xs[bad[0] - 1]


def optimize_r34(damping):
    """Phase 1: maximize real-axis stability of 1+z+z^2/2+r3 z^3+r4 z^4
    subject to |R| <= damping on the interior of the interval."""

    def neg_size(p):
        r3, r4 = p
        return -real_axis_size(np.array([1.0, 1.0, 0.5, r3, r4]), damping)

    best = (0.0, (0.0, 0.0))
    # log-grid seeds: optimal r3, r4 are small positive numbers
    for r3 in np.geomspace(1e-4, 0.2, 24):
        for r4 in np.geomspace(1e-6, 0.02, 24):
            s = -neg_size((r3, r4))
            if s > best[0]:
                best = (s, (r3, r4))
    res = optimize.minimize(neg_size, best[1], method="Nelder-Mead",
                            options={"xatol": 1e-12, "fatol": 1e-12,
                                     "maxiter": 4000})
    r3, r4 = res.x
    size = -res.fun
    return float(r3), float(r4), float(size)


def realize_tableau(r3, r4, name, damping):
    """Phase 2: find a 4-stage drift tableau with the given r3, r4.

    Chebyshev-like stage layout: c2 < c3 < c4 with chained A0. Unknowns:
    a21, a31, a32, a41, a42, a43, alpha(4). Equations:
      r3 = a3.A0^2 e = al3*a32*c2 + al4*(a42*c2 + a43*c3)
      r4 = al4*a43*a32*c2
      sum(alpha) = 1 ; alpha.c = 1/2
    Heuristic closure: fix stage times c = (0, c2, c3, c4) from a damped
    Chebyshev profile, alpha weighted toward late stages, then least
    squares for the A0 entries.
    """

    def residual(v):
        a21, a31, a32, a41, a42, a43, al1, al2, al3, al4 = v
        c2 = a21
        c3 = a31 + a32
        c4 = a41 + a42 + a43
        eq = [
            al1 + al2 + al3 + al4 - 1.0,
            al2 * c2 + al3 * c3 + al4 * c4 - 0.5,
            al3 * a32 * c2 + al4 * (a42 * c2 + a43 * c3) - r3,
            al4 * a43 * a32 * c2 - r4,
        ]
        # soft shaping: keep stage times inside [0, 1] and increasing
        pen = []
        for c in (c2, c3, c4):
            pen.append(10.0 * max(0.0, -c) + 10.0 * max(0.0, c - 1.0))
        pen.append(5.0 * max(0.0, c2 - c3))
        pen.append(5.0 * max(0.0, c3 - c4))
        return np.array(eq + pen)

    rng = np.random.default_rng(0)
    best = None
    for _ in range(200):
        v0 = np.array([
            rng.uniform(0.05, 0.4),               # a21
            rng.uniform(0.0, 0.3), rng.uniform(0.1, 0.6),   # a3*
            rng.uniform(0.0, 0.3), rng.uniform(0.0, 0.4), rng.uniform(0.1, 0.7),
            rng.uniform(-0.2, 0.5), rng.uniform(-0.2, 0.5),
            rng.uniform(-0.2, 0.8), rng.uniform(0.2, 1.2),
        ])
        sol = optimize.least_squares(residual, v0, xtol=1e-15, ftol=1e-15,
                                     gtol=1e-15)
        r = np.abs(residual(sol.x)[:4]).max()
        if r < 1e-12:
            # prefer small coefficients (conditioning)
            score = np.abs(sol.x).max()
            if best is None or score < best[0]:
                best = (score, sol.x.copy())
    assert best is not None, "no tableau realization found"
    a21, a31, a32, a41, a42, a43, al1, al2, al3, al4 = best[1]
    alpha = np.array([al1, al2, al3, al4])

    # B0 placement: alpha.q = 1, alpha.q^2 = 3/2 with q=(0,q2,q3,q4),
    # minimum-norm via parameterized 1-D search over q4.
    def solve_q(q4):
        # solve al2 q2 + al3 q3 = 1 - al4 q4 ; al2 q2^2 + al3 q3^2 = 1.5 - al4 q4^2
        b1 = 1.0 - alpha[3] * q4
        b2 = 1.5 - alpha[3] * q4 ** 2
        # parameterize q2 = t; q3 = (b1 - al2 t)/al3; match second eq
        def f(t):
            q3 = (b1 - alpha[1] * t) / alpha[2]
            return alpha[1] * t ** 2 + alpha[2] * q3 ** 2 - b2
        # find roots by scanning
        ts = np.linspace(-6, 6, 20001)
        vals = np.array([f(t) for t in ts])
        sign = np.sign(vals)
        roots = []
        for i in np.nonzero(np.diff(sign) != 0)[0]:
            t = optimize.brentq(f, ts[i], ts[i + 1])
            q3 = (b1 - alpha[1] * t) / alpha[2]
            roots.append((t, q3))
        return roots

    bestq = None
    for q4 in np.linspace(-3, 3, 241):
        for (q2, q3) in solve_q(q4):
            norm = q2 * q2 + q3 * q3 + q4 * q4
            if bestq is None or norm < bestq[0]:
                bestq = (norm, (q2, q3, q4))
    assert bestq is not None, "no B0 placement found"
    q2, q3, q4 = bestq[1]

    tab = sri.SRITableau(
        name=name,
        c0=(0.0, a21, a31 + a32, a41 + a42 + a43),
        c1=sri.SRIW1.c1,
        A0=sri._rows((0, 0, 0, 0), (a21, 0, 0, 0), (a31, a32, 0, 0),
                     (a41, a42, a43, 0)),
        A1=sri.SRIW1.A1,
        B0=sri._rows((0, 0, 0, 0), (q2, 0, 0, 0), (q3, 0, 0, 0),
                     (q4, 0, 0, 0)),
        B1=sri.SRIW1.B1,
        alpha=(al1, al2, al3, al4),
        beta1=sri.SRIW1.beta1,
        beta2=sri.SRIW1.beta2,
        beta3=sri.SRIW1.beta3,
        beta4=sri.SRIW1.beta4,
        delta=1.0 / 6.0,
        # natural embedding: drift residual vs the embedded Euler pair
        e_drift=(al1 - 1.0, al2, al3, al4),
        e_noise=(1.0, 0.0, 0.0, -1.0),
    )
    return tab


def report(tab, damping):
    res = sri.order_condition_residuals(tab)
    worst = max(abs(v) for v in res.values())
    size = sri.stability_size(tab)
    print(f"# {tab.name}: worst order-condition residual {worst:.3e}, "
          f"stability size {size:.6f} (damping band {damping})")
    def plain(v):
        if isinstance(v, tuple):
            return tuple(plain(x) for x in v)
        if isinstance(v, (float, np.floating)):
            return float(v)
        return v

    print(f"{tab.name.upper().replace('-', '_')} = SRITableau(")
    for field in tab._fields:
        val = plain(getattr(tab, field))
        print(f"    {field}={val!r},")
    print(")")
    return size


def main():
    for name, damping in (("sosri-opt", 0.99), ("sosri2-opt", 0.90)):
        r3, r4, size_poly = optimize_r34(damping)
        print(f"# phase1 {name}: r3={r3:.17g} r4={r4:.17g} "
              f"poly real-axis size={size_poly:.4f}")
        tab = realize_tableau(r3, r4, name, damping)
        report(tab, damping)
        print()


if __name__ == "__main__":
    main()
