"""Offline spline-basis table construction (host-side NumPy, runs once at init).

Builds dense lookup tables of M-spline, I-spline, and B-spline basis functions
(and their derivatives up to order 3) on a uniform mesh over [0, 1].  At run
time the device kernels only ever *linearly interpolate* these tables, so the
tables fully define the runtime numerics; higher-derivative tables are chained
through custom JVPs on device (see spline_eval.py).

Parity notes (reference = aspuru-guzik-group/waveflow):
  * M-spline recursion incl. analytic derivatives: splines_np.py:42-62
  * I-spline as windowed sum of scaled M-splines:  splines_np.py:79-93
  * B-spline Cox-de-Boor recursion + derivatives:  splines_np.py:101-137
  * Knot-vector construction (clamped/cardinal):   msplines_jax.py:72-74,
    isplines_jax.py:91-93, bsplines_jax.py:58-60
  * Orthonormalized B-basis + change matrices:     bsplines_jax.py:98-106

Unlike the reference (scalar Python recursion per mesh point, minutes of
wall-clock behind tqdm), everything here is vectorized over the whole mesh
with NumPy, so a full table set builds in milliseconds and no on-disk cache
is required.

Copy of waveflow_tpu/ops/spline_tables.py for the PyTorch port (pure NumPy;
the port keeps its own copy so that it never imports the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from waveflow_tpu_torch.ops.ortho import loewdin_orthonormalize

N_DERIVATIVES = 4  # table orders 0..3; order n+1 consumed by the JVP of order n


# ---------------------------------------------------------------------------
# Knot vectors
# ---------------------------------------------------------------------------

def make_knots(n_internal_knots: int, multiplicity: int) -> np.ndarray:
    """Uniform internal knots on [0,1] with the two end knots repeated.

    ``multiplicity`` is the total count of each end knot: the reference uses
    k for M-splines, k+1 for I- and B-splines (msplines_jax.py:72-74,
    isplines_jax.py:91-93, bsplines_jax.py:58-60).
    """
    internal = np.linspace(0.0, 1.0, n_internal_knots)
    return np.concatenate([
        np.zeros(multiplicity - 1),
        internal,
        np.ones(multiplicity - 1),
    ])


# ---------------------------------------------------------------------------
# Vectorized basis recursions.  x: (P,) mesh points; returns (n_bases, P).
# ---------------------------------------------------------------------------

def _m_order1(x: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Order-1 (degree-0) M-splines: 1/(t[i+1]-t[i]) on [t_i, t_{i+1}).

    The final nonempty interval is closed on the right so that x = 1 lies in
    the support (matches the half-open/closed convention of splines_np.py:44).
    """
    n = len(t) - 1
    out = np.zeros((n, len(x)))
    # index of last interval with positive length
    nonempty = np.nonzero(t[1:] > t[:-1])[0]
    last = nonempty[-1] if len(nonempty) else -1
    for i in nonempty:
        if i == last:
            mask = (x >= t[i]) & (x <= t[i + 1])
        else:
            mask = (x >= t[i]) & (x < t[i + 1])
        out[i, mask] = 1.0 / (t[i + 1] - t[i])
    return out


def m_basis_with_derivs(x: np.ndarray, t: np.ndarray, k: int,
                        n_derivatives: int = N_DERIVATIVES) -> np.ndarray:
    """All M-spline bases of order k and derivatives 0..n_derivatives-1.

    Returns array of shape (n_derivatives, n_bases, P) with
    n_bases = len(t) - k.  Uses the derivative-extended Curry-Schoenberg
    recursion (the same recurrence as splines_np.py:42-62):

      M_{i,k}^{(n)} = k/((k-1)(t_{i+k}-t_i)) * [ (x-t_i) M_{i,k-1}^{(n)}
          + (t_{i+k}-x) M_{i+1,k-1}^{(n)}
          + n (M_{i,k-1}^{(n-1)} - M_{i+1,k-1}^{(n-1)}) ]
    """
    P = len(x)
    # D[n][i] at current order; start with order 1
    cur = np.zeros((n_derivatives, len(t) - 1, P))
    cur[0] = _m_order1(x, t)
    for order in range(2, k + 1):
        n_b = len(t) - order
        nxt = np.zeros((n_derivatives, n_b, P))
        denom = t[order:] - t[:-order]  # t[i+order] - t[i], shape (n_b,)
        safe = denom > 0
        coef = np.zeros(n_b)
        coef[safe] = order / ((order - 1) * denom[safe])
        left = (x[None, :] - t[:n_b, None])        # x - t_i
        right = (t[order:, None] - x[None, :])     # t_{i+order} - x
        for n in range(n_derivatives):
            term = left * cur[n, :n_b] + right * cur[n, 1:n_b + 1]
            if n > 0:
                term = term + n * (cur[n - 1, :n_b] - cur[n - 1, 1:n_b + 1])
            nxt[n] = coef[:, None] * term
        cur = nxt
    return cur


def b_basis_with_derivs(x: np.ndarray, t: np.ndarray, k: int,
                        n_derivatives: int = N_DERIVATIVES) -> np.ndarray:
    """All B-spline bases of degree k and derivatives 0..n_derivatives-1.

    Shape (n_derivatives, n_bases, P), n_bases = len(t) - k - 1.
    Values via Cox-de Boor (splines_np.py:101-118); derivative order n via
      B_{i,k}^{(n)} = k [ B_{i,k-1}^{(n-1)}/(t_{i+k}-t_i)
                        - B_{i+1,k-1}^{(n-1)}/(t_{i+k+1}-t_{i+1}) ]
    applied recursively (splines_np.py:127-137).
    """
    P = len(x)

    def values(deg: int) -> np.ndarray:
        """B-spline *values* of degree ``deg``: (len(t)-deg-1, P)."""
        # degree 0: indicator (closed right end on last nonempty interval)
        out = np.zeros((len(t) - 1, P))
        nonempty = np.nonzero(t[1:] > t[:-1])[0]
        last = nonempty[-1] if len(nonempty) else -1
        for i in nonempty:
            if i == last:
                mask = (x >= t[i]) & (x <= t[i + 1])
            else:
                mask = (x >= t[i]) & (x < t[i + 1])
            out[i, mask] = 1.0
        for d in range(1, deg + 1):
            n_b = len(t) - d - 1
            nxt = np.zeros((n_b, P))
            for i in range(n_b):
                acc = np.zeros(P)
                if t[i + d] > t[i]:
                    acc += (x - t[i]) / (t[i + d] - t[i]) * out[i]
                if t[i + d + 1] > t[i + 1]:
                    acc += (t[i + d + 1] - x) / (t[i + d + 1] - t[i + 1]) * out[i + 1]
                nxt[i] = acc
            out = nxt
        return out

    def derivs(deg: int, n: int) -> np.ndarray:
        """n-th derivative of degree-``deg`` B-splines: (len(t)-deg-1, P)."""
        if n == 0:
            return values(deg)
        if deg == 0:
            return np.zeros((len(t) - 1, P))
        lower = derivs(deg - 1, n - 1)  # (len(t)-deg, P)
        n_b = len(t) - deg - 1
        out = np.zeros((n_b, P))
        for i in range(n_b):
            acc = np.zeros(P)
            if t[i + deg] > t[i]:
                acc += lower[i] / (t[i + deg] - t[i])
            if t[i + deg + 1] > t[i + 1]:
                acc -= lower[i + 1] / (t[i + deg + 1] - t[i + 1])
            out[i] = deg * acc
        return out

    n_bases = len(t) - k - 1
    res = np.zeros((n_derivatives, n_bases, P))
    for n in range(n_derivatives):
        res[n] = derivs(k, n)
    return res


def i_basis_with_derivs(x: np.ndarray, t: np.ndarray, k: int,
                        n_derivatives: int = N_DERIVATIVES) -> np.ndarray:
    """All I-spline bases of degree k and derivatives 0..n_derivatives-1.

    Shape (n_derivatives, n_bases, P), n_bases = len(t) - k (the reference's
    count, isplines_jax.py:94-95).  I-splines are running integrals of scaled
    order-(k+1) M-splines (splines_np.py:79-93):

      I_{i}(x) = sum_{m=i..j} (t_{m+k+1} - t_m) M_{m,k+1}(x) / (k+1),
      j = index of the knot interval containing x.

    Because M_{m,k+1} vanishes outside [t_m, t_{m+k+1}], the windowed sum
    equals the full suffix sum over m >= i, with the convention that once all
    in-support terms are included the value saturates at 1.  We therefore
    compute suffix sums of the scaled M-spline terms and clamp the value
    (derivatives need no clamp: they are exactly 0 in the saturated region
    because the in-window M-derivatives sum to d/dx 1 = 0).
    """
    m_tab = m_basis_with_derivs(x, t, k + 1, n_derivatives)  # (nd, len(t)-k-1, P)
    n_m = m_tab.shape[1]
    scale = (t[k + 1:k + 1 + n_m] - t[:n_m]) / (k + 1)        # (n_m,)
    terms = m_tab * scale[None, :, None]
    # suffix sum over basis index
    suf = np.flip(np.cumsum(np.flip(terms, axis=1), axis=1), axis=1)
    n_bases = len(t) - k
    out = np.zeros((n_derivatives, n_bases, len(x)))
    out[:, :n_m] = suf
    # value table: the suffix sum already telescopes to 1 in the saturated
    # region (partition of unity of scaled M), clamp tiny float drift.
    out[0] = np.clip(out[0], 0.0, 1.0)
    return out


# ---------------------------------------------------------------------------
# Assembled table sets
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SplineTables:
    """Device-ready spline tables for one basis family.

    tables:  (n_derivatives, n_mesh, n_bases) float32 — note the transposed
             layout vs the reference ((deriv, basis, mesh)); rows are mesh
             points so a batched row gather yields (batch, n_bases) basis
             matrices feeding a fused dot with per-sample coefficients.
    knots:   (n_knots,) float64 knot vector.
    left:    (n_derivatives, n_bases) basis values at x=0 (column 0).
    right:   (n_derivatives, n_bases) basis values at x=1 (last column).
    """
    kind: str
    degree: int
    n_internal_knots: int
    n_mesh: int
    tables: np.ndarray
    knots: np.ndarray

    @property
    def n_bases(self) -> int:
        return self.tables.shape[2]

    @property
    def left(self) -> np.ndarray:
        return self.tables[:, 0, :]

    @property
    def right(self) -> np.ndarray:
        return self.tables[:, -1, :]


@dataclass(frozen=True)
class BSplineTables(SplineTables):
    """B-spline tables plus the symmetric-Gram-Schmidt orthonormal basis.

    ob_tables: orthonormalized ("OB") basis tables, same layout as `tables`.
    b_to_ob / ob_to_b: (n_bases, n_bases) basis-change matrices
                       (bsplines_jax.py:98-106).
    """
    ob_tables: np.ndarray = None
    b_to_ob: np.ndarray = None
    ob_to_b: np.ndarray = None

    @property
    def ob_left(self) -> np.ndarray:
        return self.ob_tables[:, 0, :]

    @property
    def ob_right(self) -> np.ndarray:
        return self.ob_tables[:, -1, :]


def build_mspline_tables(degree: int, n_internal_knots: int,
                         n_mesh: int = 1000) -> SplineTables:
    """M-spline tables: knot multiplicity k at ends (msplines_jax.py:72-74)."""
    t = make_knots(n_internal_knots, degree)
    mesh = np.linspace(0.0, 1.0, n_mesh)
    tab = m_basis_with_derivs(mesh, t, degree)            # (nd, n_bases, P)
    tab = np.ascontiguousarray(np.swapaxes(tab, 1, 2))    # (nd, P, n_bases)
    return SplineTables('M', degree, n_internal_knots, n_mesh,
                        tab.astype(np.float32), t)


def build_ispline_tables(degree: int, n_internal_knots: int,
                         n_mesh: int = 1000) -> SplineTables:
    """I-spline tables: knot multiplicity k+1 at ends (isplines_jax.py:91-93)."""
    t = make_knots(n_internal_knots, degree + 1)
    mesh = np.linspace(0.0, 1.0, n_mesh)
    tab = i_basis_with_derivs(mesh, t, degree)
    tab = np.ascontiguousarray(np.swapaxes(tab, 1, 2))
    return SplineTables('I', degree, n_internal_knots, n_mesh,
                        tab.astype(np.float32), t)


def build_bspline_tables(degree: int, n_internal_knots: int,
                         n_mesh: int = 1000) -> BSplineTables:
    """B-spline + orthonormalized-B tables (bsplines_jax.py:58-116).

    The OB basis has unit square-integral on [0,1] (the property the model's
    exact normalization relies on, bsplines_jax.py:100 & wavefunctions.py:65).
    We use exact Löwdin symmetric orthogonalization (see ops/ortho.py) so
    b_to_ob = S^{-1/2} and ob_to_b = S^{1/2} are exact inverses; evaluating
    (w @ ob_to_b) against the OB basis is then *identical* to evaluating w
    against the raw B basis, making boundary-condition projection in B-space
    exactly consistent with OB-space evaluation.  Derivative tables of the OB
    basis are the B derivative tables mapped through b_to_ob
    (cf. bsplines_jax.py:106).
    """
    t = make_knots(n_internal_knots, degree + 1)
    mesh = np.linspace(0.0, 1.0, n_mesh)
    tab = b_basis_with_derivs(mesh, t, degree)            # (nd, n_bases, P)
    b_values = tab[0]                                      # (n_bases, P)
    ob_values, b_to_ob, ob_to_b = loewdin_orthonormalize(b_values)
    ob_tab = np.einsum('ab,dbp->dap', b_to_ob, tab)
    ob_tab[0] = ob_values
    tab = np.ascontiguousarray(np.swapaxes(tab, 1, 2))
    ob_tab = np.ascontiguousarray(np.swapaxes(ob_tab, 1, 2))
    return BSplineTables('B', degree, n_internal_knots, n_mesh,
                         tab.astype(np.float32), t,
                         ob_tables=ob_tab.astype(np.float32),
                         b_to_ob=b_to_ob.astype(np.float32),
                         ob_to_b=ob_to_b.astype(np.float32))


_BUILDERS = {
    'M': build_mspline_tables,
    'I': build_ispline_tables,
    'B': build_bspline_tables,
}

_TABLE_CACHE: dict = {}


def get_tables(kind: str, degree: int, n_internal_knots: int,
               n_mesh: int = 1000):
    """Build (or fetch memoized) tables for a basis family.

    In-process memoization only: the vectorized construction takes milliseconds,
    so the port keeps no on-disk cache.
    """
    key = (kind, degree, n_internal_knots, n_mesh)
    if key not in _TABLE_CACHE:
        _TABLE_CACHE[key] = _BUILDERS[kind](degree, n_internal_knots, n_mesh)
    return _TABLE_CACHE[key]
