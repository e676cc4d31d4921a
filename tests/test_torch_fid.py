"""``metrics.unpaired.frechet_distance_of`` (the Fréchet distance of two
feature sets in the span of their centred features, which the evaluator's
unpaired runner uses).

Against the JAX package's ``frechet_distance`` of ``gaussian_stats`` on
the CPU, on seeded features of FID's shapes: a few frames in 512 to
3,072 dimensions (the reference's D² route takes minutes at PCB's
12,288), and sets as large as the dimension (where it falls back to the
D² route, exactly). Features of scale 0.05, where the D² route's
rounding of its D - k near-zero eigenvalues stays below 1e-9 of the
distance: within 1e-8 of max(|FD|, 1).

Against the closed form at the scale of real features: two sets of 16
frames whose covariances share their eigenvectors (eigenvalues up to
100 and 1,000, traces ~870 and ~8,700, the distance a few units: the
sets nearly equal), so that Tr sqrt((S1 + eps)(S2 + eps)) is a sum over
the shared eigenvalues, in 2,048 (InceptionV3's pool) and 12,288 (PCB's
six parts) dimensions: within 1e-9 of the distance. The D² route's gap
to the closed form at 2,048 dimensions is printed (``pytest -s``)."""

import numpy as np
import pytest

from impersonator_tpu.metrics import unpaired as JU
from impersonator_tpu_torch.metrics import unpaired as TU


@pytest.mark.parametrize("n1,n2,d", [(4, 4, 512), (6, 6, 2048),
                                     (4, 5, 3072), (16, 16, 24),
                                     (2, 3, 64)])
def test_frechet_distance_of_matches_jax(n1, n2, d):
    rng = np.random.default_rng(n1 * 1000 + d)
    f1 = rng.standard_normal((n1, d)) * 0.05
    f2 = f1[:1] + rng.standard_normal((n2, d)) * 0.05
    got = TU.frechet_distance_of(f1.astype(np.float32),
                                 f2.astype(np.float32))
    want = JU.frechet_distance(*JU.gaussian_stats(f1.astype(np.float32)),
                               *JU.gaussian_stats(f2.astype(np.float32)))
    assert abs(got - want) <= 1e-8 * max(abs(want), 1.0), (got, want)
    if n1 + n2 >= d:
        assert got == want


def commuting_sets(n, d, scale, seed, eps=1e-6):
    """Two (n, d) float64 feature sets whose sample covariances are
    R diag(a) Rᵀ and R diag(b) Rᵀ (R: d x (n - 1), orthonormal; a up to
    ``scale``, b within 5% of a), their means 1e-2 apart per dimension,
    and their Fréchet distance with ``eps`` in closed form."""
    rng = np.random.default_rng(seed)
    k = n - 1
    r, _ = np.linalg.qr(rng.standard_normal((d, k)))

    def feats(lam, mu):
        c = rng.standard_normal((n, k))
        u, _ = np.linalg.qr(c - c.mean(0))      # columns ⟂ the ones vector
        return mu + np.sqrt(n - 1) * (u * np.sqrt(lam)) @ r.T

    a = rng.uniform(0.2, 1.0, k) * scale
    b = a * rng.uniform(0.95, 1.05, k)
    mu1 = rng.uniform(0.0, 0.5, d)
    mu2 = mu1 + rng.standard_normal(d) * 1e-2
    exact = (np.sum((mu1 - mu2) ** 2) + a.sum() + b.sum()
             - 2 * (np.sum(np.sqrt((a + eps) * (b + eps))) + (d - k) * eps))
    return feats(a, mu1), feats(b, mu2), exact


@pytest.mark.parametrize("d,scale", [(2048, 100.0), (2048, 1000.0),
                                     (12288, 1000.0)])
def test_frechet_distance_of_closed_form(d, scale):
    f1, f2, exact = commuting_sets(16, d, scale, seed=d + int(scale))
    got = TU.frechet_distance_of(f1, f2)
    assert abs(got - exact) <= 1e-9 * exact, (got, exact)
    if d <= 2048:
        want = JU.frechet_distance(*JU.gaussian_stats(f1),
                                   *JU.gaussian_stats(f2))
        print(f"D={d}, eigenvalues up to {scale:g}: closed form {exact:.9g}, "
              f"span route {(got - exact) / exact:.3e}, the JAX package's "
              f"D² route {(want - exact) / exact:.3e} of the distance")
