"""Dense Gaussian-process toolkit (reference: utils/gaussian_process.py +
cho_solver.py, SURVEY.md §2 "GP toolkit").

Composable stationary kernels (SE, rational quadratic, Matérn family,
sums/products), exact GP regression via on-device Cholesky, marginal-
likelihood hyperparameter optimisation with jax autodiff + BFGS, and
batched (vmapped) solves — used for screen-level fits over (antenna,
direction) coordinates, where N is small and dense linear algebra is the
right tool (contrast the grid-scale FFT covariance operator in
inversion.priors).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.flatten_util  # noqa: F401 — registers jax.flatten_util
import jax.numpy as jnp


# --- kernels -----------------------------------------------------------------


class Kernel:
    """Base: kernels are callables k(X1, X2) -> (N1, N2) and compose."""

    def __call__(self, x1, x2):
        raise NotImplementedError

    def __add__(self, other):
        return SumKernel(self, other)

    def __mul__(self, other):
        return ProductKernel(self, other)

    # hyperparameter pytree plumbing
    def params(self) -> dict:
        raise NotImplementedError

    def with_params(self, p: dict) -> "Kernel":
        raise NotImplementedError


def _sqdist(x1, x2):
    x1 = jnp.atleast_2d(x1)
    x2 = jnp.atleast_2d(x2)
    d = x1[:, None, :] - x2[None, :, :]
    return jnp.sum(d * d, axis=-1)


@dataclasses.dataclass
class SquaredExponential(Kernel):
    sigma: float = 1.0
    length_scale: float = 1.0

    def __call__(self, x1, x2):
        r2 = _sqdist(x1, x2)
        return self.sigma**2 * jnp.exp(-0.5 * r2 / self.length_scale**2)

    def params(self):
        return {"sigma": self.sigma, "length_scale": self.length_scale}

    def with_params(self, p):
        return SquaredExponential(**p)


@dataclasses.dataclass
class RationalQuadratic(Kernel):
    sigma: float = 1.0
    length_scale: float = 1.0
    alpha: float = 1.0

    def __call__(self, x1, x2):
        r2 = _sqdist(x1, x2)
        return self.sigma**2 * (
            1.0 + 0.5 * r2 / (self.alpha * self.length_scale**2)
        ) ** (-self.alpha)

    def params(self):
        return {"sigma": self.sigma, "length_scale": self.length_scale,
                "alpha": self.alpha}

    def with_params(self, p):
        return RationalQuadratic(**p)


@dataclasses.dataclass
class Matern(Kernel):
    """Matérn ν ∈ {0.5, 1.5, 2.5} (the closed-form family)."""

    sigma: float = 1.0
    length_scale: float = 1.0
    nu: float = 1.5

    def __call__(self, x1, x2):
        r = jnp.sqrt(jnp.maximum(_sqdist(x1, x2), 1e-30))
        x = r / self.length_scale
        if self.nu == 0.5:
            k = jnp.exp(-x)
        elif self.nu == 1.5:
            a = jnp.sqrt(3.0) * x
            k = (1.0 + a) * jnp.exp(-a)
        elif self.nu == 2.5:
            a = jnp.sqrt(5.0) * x
            k = (1.0 + a + a * a / 3.0) * jnp.exp(-a)
        else:
            raise ValueError("nu must be 0.5, 1.5 or 2.5")
        return self.sigma**2 * k

    def params(self):
        return {"sigma": self.sigma, "length_scale": self.length_scale}

    def with_params(self, p):
        return Matern(nu=self.nu, **p)


@dataclasses.dataclass
class SumKernel(Kernel):
    a: Kernel
    b: Kernel

    def __call__(self, x1, x2):
        return self.a(x1, x2) + self.b(x1, x2)

    def params(self):
        return {"a": self.a.params(), "b": self.b.params()}

    def with_params(self, p):
        return SumKernel(self.a.with_params(p["a"]),
                         self.b.with_params(p["b"]))


@dataclasses.dataclass
class ProductKernel(Kernel):
    a: Kernel
    b: Kernel

    def __call__(self, x1, x2):
        return self.a(x1, x2) * self.b(x1, x2)

    def params(self):
        return {"a": self.a.params(), "b": self.b.params()}

    def with_params(self, p):
        return ProductKernel(self.a.with_params(p["a"]),
                             self.b.with_params(p["b"]))


# --- cho_solver equivalents ---------------------------------------------------


def cho_solve_stack(k_matrix, y, jitter=1e-6):
    """Cholesky solve K x = y with adaptive-free fixed jitter.

    k_matrix: (..., N, N) SPD (batched OK), y: (..., N) or (..., N, M).
    """
    n = k_matrix.shape[-1]
    k = k_matrix + jitter * jnp.trace(k_matrix, axis1=-2, axis2=-1)[
        ..., None, None] / n * jnp.eye(n, dtype=k_matrix.dtype)
    chol = jnp.linalg.cholesky(k)
    y2 = y[..., None] if y.ndim == k.ndim - 1 else y
    x = jax.scipy.linalg.cho_solve((chol, True), y2)
    return (x[..., 0] if y.ndim == k.ndim - 1 else x), chol


def log_marginal_likelihood(kernel: Kernel, x, y, noise_std):
    """Exact GP log evidence: -½ yᵀK⁻¹y − ½ log|K| − N/2 log 2π."""
    n = x.shape[0]
    k = kernel(x, x) + (noise_std**2) * jnp.eye(n)
    alpha, chol = cho_solve_stack(k, y)
    return (-0.5 * jnp.vdot(y, alpha)
            - jnp.sum(jnp.log(jnp.diagonal(chol)))
            - 0.5 * n * jnp.log(2.0 * jnp.pi))


def gp_predict(kernel: Kernel, x, y, noise_std, x_star):
    """Posterior mean and variance at x_star."""
    n = x.shape[0]
    k = kernel(x, x) + (noise_std**2) * jnp.eye(n)
    alpha, chol = cho_solve_stack(k, y)
    ks = kernel(x, x_star)                      # (N, M)
    mean = ks.T @ alpha
    v = jax.scipy.linalg.solve_triangular(chol, ks, lower=True)
    var = jnp.clip(jnp.diagonal(kernel(x_star, x_star))
                   - jnp.sum(v * v, axis=0), 0.0)
    return mean, var


def fit_hyperparameters(kernel: Kernel, x, y, noise_std, steps=200,
                        lr=5e-2):
    """Maximise the marginal likelihood over log-hyperparameters (Adam-style
    on-device loop under lax.scan — the reference used scipy.optimize).

    Returns (fitted kernel, final -log evidence).
    """
    p0 = kernel.params()
    flat0, unravel = jax.flatten_util.ravel_pytree(
        jax.tree.map(jnp.log, jax.tree.map(jnp.asarray, p0)))

    def neg_lml(flat_logp):
        k = kernel.with_params(jax.tree.map(jnp.exp, unravel(flat_logp)))
        return -log_marginal_likelihood(k, x, y, noise_std)

    grad_fn = jax.value_and_grad(neg_lml)

    def step(carry, _):
        flat, m, v, t = carry
        loss, g = grad_fn(flat)
        t = t + 1
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1 - 0.9**t)
        vhat = v / (1 - 0.999**t)
        flat = flat - lr * mhat / (jnp.sqrt(vhat) + 1e-8)
        return (flat, m, v, t), loss

    init = (flat0, jnp.zeros_like(flat0), jnp.zeros_like(flat0), 0.0)
    (flat, *_), losses = jax.lax.scan(step, init, None, length=steps)
    fitted = kernel.with_params(jax.tree.map(jnp.exp, unravel(flat)))
    return fitted, float(losses[-1])
