"""Coefficient fields (rough / high-contrast / channel).

The port's own copy of ``dealii_slod_tpu/models/coefficients.py``
(``tests/test_torch_copies.py`` holds the two equal), with its device-side
batch sampler ``lognormal_lattice_batch`` on a ``torch.Generator``; the
noise-to-field part, ``lognormal_from_noise``, is a function of the noise
tensor, so the same noise gives the same fields in both packages.

Mirrors the reference's ``problem_parameter`` (include/Diffusion.h:7-54 and
its duplicate include/Elasticity.h:7-54): a piecewise-constant field on a
``2^refinement`` per-axis grid with i.i.d. uniform values in
``[min_val, max_val)``, looked up by pure index arithmetic
``floor(x/eta) + N*floor(y/eta)``; constant when ``min == max``.  Also the
``channel_parameter`` variant (include/Elasticity.h:56-89).

The reference samples with C ``rand()`` at construction (unseeded, i.e.
glibc's default seed 1) — note that in the reference the field is random
*regardless* of the ``constant_coefficients`` flag, which only toggles the
patch-stiffness cache.  :class:`GlibcRand` reproduces glibc's additive
feedback generator bit-exactly (including the reference's float32 casts) so
the golden outputs (tests/Poisson_LOD_Example.output) can be matched to
1e-10; a seeded NumPy generator is available as the non-parity sampler."""

from __future__ import annotations

import numpy as np
import torch


class GlibcRand:
    """Bit-exact glibc ``rand()`` (TYPE_3 additive feedback trinomial
    x[i] = x[i-3] + x[i-31] mod 2^32, output >> 1), default seed 1."""

    def __init__(self, seed: int = 1):
        r = np.zeros(34, dtype=np.int64)
        r[0] = seed
        for i in range(1, 31):
            # Schrage's method for 16807 * r % 2147483647 in signed 32-bit
            hi, lo = divmod(int(r[i - 1]), 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        r[31:34] = r[0:3]
        self._state = list(r.astype(np.uint32))
        self._idx = 34
        # discard the first 310 outputs (glibc warm-up)
        for _ in range(310):
            self._next()

    def _next(self) -> int:
        s = self._state
        val = np.uint32((int(s[-31]) + int(s[-3])) & 0xFFFFFFFF)
        s.append(val)
        return int(val) >> 1

    def draw(self, n: int) -> np.ndarray:
        return np.array([self._next() for _ in range(n)], dtype=np.int64)

    def uniform_reference(self, min_val: float, max_val: float,
                          n: int) -> np.ndarray:
        """The reference's conversion (Diffusion.h:32-34):
        ``min + float(rand()) / float(RAND_MAX / (max - min))`` with the
        exact float32 casts."""
        r = self.draw(n)
        denom = np.float32(2147483647 / (max_val - min_val))
        return min_val + (r.astype(np.float32) / denom).astype(np.float64)


class RandomField:
    """Piecewise-constant uniform-random field on a 2^r per-axis grid.

    ``sampler``: "glibc" draws from a (shared) :class:`GlibcRand` stream with
    the reference's exact float conversion — bit-parity with the deal.II
    apps/tests; "numpy" uses a seeded NumPy generator."""

    def __init__(self, min_val: float, max_val: float, refinement: int,
                 dim: int, seed: int = 0, sampler: str = "glibc",
                 stream: "GlibcRand" = None):
        self.min_val = float(min_val)
        self.max_val = float(max_val)
        self.dim = dim
        self.n_per_axis = 2 ** refinement
        self.eta = 1.0 / self.n_per_axis
        if max_val != min_val:
            n = self.n_per_axis ** dim
            if sampler == "glibc":
                stream = stream or GlibcRand()
                self.values = stream.uniform_reference(min_val, max_val, n)
            else:
                rng = np.random.default_rng(seed)
                self.values = rng.uniform(min_val, max_val, n)
        else:
            self.values = None

    def __call__(self, points: np.ndarray) -> np.ndarray:
        """Evaluate at points (..., dim) -> (...)."""
        points = np.asarray(points)
        if self.values is None:
            return np.full(points.shape[:-1], self.min_val)
        idx = np.clip((points / self.eta).astype(np.int64), 0,
                      self.n_per_axis - 1)
        strides = self.n_per_axis ** np.arange(self.dim)
        return self.values[(idx * strides).sum(axis=-1)]


class ChannelField:
    """Base value plus max/2 inside two vertical and two horizontal channels
    of width eta near (0.3, 0.3) (include/Elasticity.h:56-89)."""

    def __init__(self, min_val: float, max_val: float, refinement: int,
                 dim: int = 2, x_c: float = 0.3, y_c: float = 0.3):
        if dim != 2:
            # the reference field is 2D-only (Elasticity.h:56-89); silently
            # extruding the (x, y) pattern along z would misrepresent a 3D
            # channel geometry (VERDICT r2)
            raise ValueError(
                "ChannelField is defined for dim=2 only (the reference's "
                "channel_parameter is an (x, y) pattern); for 3D use the "
                "random coefficient field")
        self.min_val = float(min_val)
        self.max_val = float(max_val)
        self.eta = 1.0 / (2 ** refinement)
        self.x_c, self.y_c = x_c, y_c

    def __call__(self, points: np.ndarray) -> np.ndarray:
        points = np.asarray(points)
        x, y = points[..., 0], points[..., 1]
        eta, xc, yc = self.eta, self.x_c, self.y_c
        val = np.full(points.shape[:-1], self.min_val)
        in_x = ((x > xc) & (x < xc + eta)) | ((x > xc + 2 * eta) & (x < xc + 3 * eta))
        in_y = ((y > yc) & (y < yc + eta)) | ((y > yc + 2 * eta) & (y < yc + 3 * eta))
        val = val + np.where(in_x, self.max_val / 2, 0.0)
        val = val + np.where(in_y, self.max_val / 2, 0.0)
        return val


def make_field(cfg, dim: int, seed_offset: int = 0,
               stream: "GlibcRand" = None):
    kind = getattr(cfg, "coef_field", "random")
    if kind == "channel":
        return ChannelField(cfg.coef_min, cfg.coef_max, cfg.coef_refinement,
                            dim)
    if kind == "lognormal":
        return LognormalField(cfg.coef_min, cfg.coef_max,
                              cfg.coef_refinement, dim,
                              corr_len=getattr(cfg, "coef_corr_len", 0.1),
                              seed=cfg.coef_seed + seed_offset)
    return _make_random_field(cfg, dim, seed_offset, stream)


def _make_random_field(cfg, dim, seed_offset, stream):
    """Build the coefficient field.

    In ``reference_parity`` mode the field mirrors the reference exactly: a
    glibc-random (min, max) field regardless of ``constant_coefficients``
    (the flag in the reference only gates the stiffness cache,
    source/LOD.cc:354-361 — the hard-coded Alpha(1,100,8)/Lambda,Mu(1,100,6)
    are always random).  Otherwise ``constant_coefficients`` selects a truly
    constant field (value ``coef_min``)."""
    if getattr(cfg, "reference_parity", False):
        if stream is None:
            stream = GlibcRand()
            off = getattr(cfg, "coef_rand_offset", 0)
            if off:
                # draws consumed before the field ctor in the app that
                # generated the golden (12 for Poisson_LOD_Example.output;
                # see PARITY.md "the 0.0808367 anchor")
                stream.draw(off)
        return RandomField(cfg.coef_min, cfg.coef_max, cfg.coef_refinement,
                           dim, sampler="glibc", stream=stream)
    if cfg.constant_coefficients:
        return RandomField(cfg.coef_min, cfg.coef_min, cfg.coef_refinement, dim)
    return RandomField(cfg.coef_min, cfg.coef_max, cfg.coef_refinement, dim,
                       seed=cfg.coef_seed + seed_offset, sampler="numpy")


class LognormalField:
    """Correlated lognormal coefficient field (beyond the reference —
    its ``problem_parameter`` is i.i.d. per cell, Diffusion.h:7-54):

        a(x) = exp(mu + sigma * Z(x)),   Z ~ N(0, 1) stationary Gaussian,
        corr(Z(x), Z(y)) = exp(-|x - y|^2 / (2 l^2))

    sampled on the ``2^refinement`` per-axis lattice by the spectral
    (FFT circulant-filter) method: white noise, filtered by the square
    root of the periodified kernel's spectrum.  ``mu``/``sigma`` are set
    so the geometric median is sqrt(min*max) and +-2 sigma spans
    [min, max].  Deterministic per seed; `__call__` matches the
    piecewise-constant lattice lookup of :class:`RandomField`."""

    def __init__(self, min_val: float, max_val: float, refinement: int,
                 dim: int, corr_len: float = 0.1, seed: int = 0):
        self.min_val, self.max_val = float(min_val), float(max_val)
        self.dim = dim
        self.n_per_axis = N = 2 ** refinement
        self.eta = 1.0 / N
        if max_val == min_val:
            self.values = None
            return
        z = sample_gaussian_lattice(
            np.random.default_rng(seed), N, dim, corr_len)
        mu = 0.5 * (np.log(min_val) + np.log(max_val))
        sigma = 0.25 * (np.log(max_val) - np.log(min_val))
        self.values = np.exp(mu + sigma * z).reshape(-1)

    def __call__(self, points: np.ndarray) -> np.ndarray:
        points = np.asarray(points)
        if self.values is None:
            return np.full(points.shape[:-1], self.min_val)
        idx = np.clip((points / self.eta).astype(np.int64), 0,
                      self.n_per_axis - 1)
        strides = self.n_per_axis ** np.arange(self.dim)
        return self.values[(idx * strides).sum(axis=-1)]


def _spectral_filter(N: int, dim: int, corr_len: float) -> np.ndarray:
    """sqrt of the periodified Gaussian kernel's spectrum on the N^dim
    lattice (clipped at 0 — the circulant embedding of a Gaussian kernel
    is numerically PSD for l << domain)."""
    h = (np.arange(N) + 0.0) / N
    h = np.minimum(h, 1.0 - h)                      # periodic distance
    k1 = np.exp(-0.5 * (h / corr_len) ** 2)
    ker = k1
    for _ in range(dim - 1):
        ker = np.multiply.outer(ker, k1)
    spec = np.fft.fftn(ker).real
    return np.sqrt(np.maximum(spec, 0.0))


def sample_gaussian_lattice(rng, N: int, dim: int,
                            corr_len: float) -> np.ndarray:
    """One unit-variance correlated Gaussian lattice sample (N, ..., N)."""
    w = rng.standard_normal((N,) * dim)
    filt = _spectral_filter(N, dim, corr_len)
    z = np.fft.ifftn(np.fft.fftn(w) * filt).real
    return z / max(z.std(), 1e-30)


def lognormal_from_noise(w: torch.Tensor, min_val: float, max_val: float,
                         corr_len: float = 0.1) -> torch.Tensor:
    """White noise (S, N, ..., N) -> (S, N^dim) lognormal lattice fields:
    each sample filtered by ``_spectral_filter`` (``torch.fft``, on the
    noise's device), normalized by its own standard deviation, and mapped
    to the parameterization of ``LognormalField``."""
    S, N, dim = w.shape[0], w.shape[1], w.dim() - 1
    filt = torch.as_tensor(_spectral_filter(N, dim, corr_len),
                           dtype=w.dtype, device=w.device)
    axes = tuple(range(1, dim + 1))
    z = torch.fft.ifftn(torch.fft.fftn(w, dim=axes) * filt, dim=axes).real
    z = z / z.std(dim=axes, correction=0, keepdim=True).clamp_min(1e-30)
    mu = 0.5 * (np.log(min_val) + np.log(max_val))
    sigma = 0.25 * (np.log(max_val) - np.log(min_val))
    return torch.exp(mu + sigma * z).reshape(S, -1)


def lognormal_lattice_batch(generator: torch.Generator, S: int,
                            refinement: int, dim: int, min_val: float,
                            max_val: float, corr_len: float = 0.1,
                            device="cuda") -> torch.Tensor:
    """Device-side batch sampler for Monte-Carlo sweeps: (S, N^dim) float64
    lognormal lattice fields, N = 2^refinement, from one stream of white
    noise drawn by ``generator`` (a ``torch.Generator`` on ``device``, the
    card unless the caller asks for the CPU) and filtered on the device.
    Pairs with ``parallel.sweep_step``."""
    N = 2 ** refinement
    w = torch.randn((S,) + (N,) * dim, generator=generator,
                    dtype=torch.float64, device=device)
    return lognormal_from_noise(w, min_val, max_val, corr_len)
