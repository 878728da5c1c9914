"""Generate the shipped blue-noise texture (void-and-cluster, Ulichney 1993).

Produces nrdsample_tpu/data/bluenoise_128.npy: a 128x128 float32 ranking in
[0,1) with a blue (high-pass) spectrum, toroidally tileable. One-time tool;
the runtime consumer is mathlib/bluenoise.py (the in-repo stand-in for the
reference's scrambling/ranking Sobol textures,
/root/reference/Shaders/RaytracingShared.hlsli:699-723).
"""
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np


def _energy_kernel(n: int, sigma: float = 1.9) -> np.ndarray:
    """Toroidal Gaussian energy kernel in frequency domain."""
    ax = np.arange(n)
    d = np.minimum(ax, n - ax).astype(np.float64)
    dx, dy = np.meshgrid(d, d, indexing="ij")
    k = np.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    return np.fft.rfft2(k)


def void_and_cluster(n: int = 128, seed: int = 7, frac_init: float = 0.1):
    rs = np.random.RandomState(seed)
    kf = _energy_kernel(n)

    def energy(binary):
        return np.fft.irfft2(np.fft.rfft2(binary) * kf, s=(n, n))

    # 1) random initial pattern, relaxed: move tightest-cluster 1 into the
    # largest void until stable
    m = int(n * n * frac_init)
    binary = np.zeros((n, n))
    idx = rs.choice(n * n, m, replace=False)
    binary.ravel()[idx] = 1.0
    for _ in range(10 * m):
        e = energy(binary)
        cl = np.unravel_index(np.argmax(np.where(binary > 0, e, -np.inf)), e.shape)
        binary[cl] = 0.0
        e = energy(binary)
        vo = np.unravel_index(np.argmin(np.where(binary > 0, np.inf, e)), e.shape)
        binary[vo] = 1.0
        if vo == cl:
            break

    rank = np.full((n, n), -1, np.int64)
    # 2) rank the initial minority points by removing tightest clusters
    b = binary.copy()
    for r in range(m - 1, -1, -1):
        e = energy(b)
        cl = np.unravel_index(np.argmax(np.where(b > 0, e, -np.inf)), e.shape)
        b[cl] = 0.0
        rank[cl] = r
    # 3) fill remaining ranks by inserting into the largest void
    b = binary.copy()
    for r in range(m, n * n):
        e = energy(b)
        vo = np.unravel_index(np.argmin(np.where(b > 0, np.inf, e)), e.shape)
        b[vo] = 1.0
        rank[vo] = r
    assert (rank >= 0).all()
    return ((rank.astype(np.float64) + 0.5) / (n * n)).astype(np.float32)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    bn = void_and_cluster(n)
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "nrdsample_tpu", "data", f"bluenoise_{n}.npy")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.save(out, bn)
    print(f"wrote {out} ({n}x{n})")
