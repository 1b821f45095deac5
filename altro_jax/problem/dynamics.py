"""Dynamics models and explicit integrators.

Replaces the reference's `ContinuousDynamics`/`DiscreteDynamics` virtual
classes (`altro/problem/dynamics.hpp:59,148`), the `ExplicitEuler`/
`RungeKutta4` integrators (`altro/problem/integration.hpp:87,113`) and the
`DiscretizedModel` adapter (`altro/problem/discretized_model.hpp:25`).

Differences from the reference:
  * Models are pure functions ``f(params, x, u, t) -> xdot`` over pytree
    params; no mutable scratch, so one model instance serves every knot point
    (the reference must copy models per knot for thread safety,
    `problem/problem.hpp:174-183`).
  * Jacobians come from `jax.jacfwd` of the *discrete* step, which is exactly
    the hand-derived RK4 chain rule in `integration.hpp:132-169`; analytic
    Jacobians (`constraint.hpp:165-168` requires them in the reference) are an
    optional override.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from .._pytree import pytree_dataclass, static_field


@pytree_dataclass
class ContinuousModel:
    """A continuous-time dynamical system ``xdot = fn(params, x, u, t)``."""

    params: Any
    fn: Callable = static_field()
    n: int = static_field()
    m: int = static_field()
    name: str = static_field(default="continuous")

    def __call__(self, x, u, t):
        return self.fn(self.params, x, u, t)

    def hessian_vp(self, x, u, t, b):
        """Dynamics Hessian-vector product ∂²(bᵀ f)/∂(x,u)² — the
        reference's `FunctionBase::Hessian(x, u, b, hess)` surface
        (`altro/common/functionbase.hpp:53-87`; the unicycle ships an
        analytic one, `examples/unicycle.cpp:33-43`).  Unused by the
        AL-iLQR solver (Gauss-Newton, like the reference's), but part of
        the L1 API: one `jax.hessian` of the b-weighted dynamics.
        Returns the (n+m)×(n+m) Hessian over the stacked (x, u) input.
        """
        x = jnp.asarray(x)
        u = jnp.asarray(u)
        n = x.shape[0]

        def scalar(z):
            return jnp.dot(jnp.asarray(b), self.fn(self.params, z[:n], z[n:], t))

        return jax.hessian(scalar)(jnp.concatenate([x, u]))


@pytree_dataclass
class DiscreteModel:
    """A discrete-time system ``x_{k+1} = fn(params, x, u, t, h)``.

    ``jac_fn(params, x, u, t, h) -> (A, B)`` defaults to forward-mode AD of
    ``fn`` (n+m input tangents, the right mode for the small wide Jacobians
    of trajectory optimization).
    """

    params: Any
    fn: Callable = static_field()
    n: int = static_field()
    m: int = static_field()
    jac_fn: Optional[Callable] = static_field(default=None)
    name: str = static_field(default="discrete")
    # Set when built by `discretize()`: lets batch-native kernels use the
    # explicit integrator Jacobian chain with layout-controlled einsums.
    continuous_fn: Optional[Callable] = static_field(default=None)
    method: Optional[str] = static_field(default=None)

    def __call__(self, x, u, t, h):
        return self.fn(self.params, x, u, t, h)

    def jacobian(self, x, u, t, h):
        """Discrete Jacobian (A [n,n], B [n,m])."""
        if self.jac_fn is not None:
            return self.jac_fn(self.params, x, u, t, h)
        return jax.jacfwd(self.fn, argnums=(1, 2))(self.params, x, u, t, h)

    def hessian_vp(self, x, u, t, h, b):
        """Discrete-dynamics Hessian-vector product ∂²(bᵀ f)/∂(x,u)² —
        see `ContinuousModel.hessian_vp` (the reference routes the same
        API through its `DiscreteDynamics`, `problem/dynamics.hpp:167-186`).
        """
        x = jnp.asarray(x)
        u = jnp.asarray(u)
        n = x.shape[0]

        def scalar(z):
            return jnp.dot(
                jnp.asarray(b), self.fn(self.params, z[:n], z[n:], t, h)
            )

        return jax.hessian(scalar)(jnp.concatenate([x, u]))


def rk4_step(f: Callable, params, x, u, t, h):
    """Classic fourth-order Runge-Kutta step (`integration.hpp:123-131`)."""
    k1 = f(params, x, u, t)
    k2 = f(params, x + 0.5 * h * k1, u, t + 0.5 * h)
    k3 = f(params, x + 0.5 * h * k2, u, t + 0.5 * h)
    k4 = f(params, x + h * k3, u, t + h)
    return x + h * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0


def euler_step(f: Callable, params, x, u, t, h):
    """Explicit Euler step (`integration.hpp:90-94`)."""
    return x + h * f(params, x, u, t)


_INTEGRATORS = {"rk4": rk4_step, "euler": euler_step}


def discretize(model: ContinuousModel, method: str = "rk4") -> DiscreteModel:
    """Adapt a continuous model into a discrete one (`discretized_model.hpp:25-65`).

    The discrete Jacobian is AD of the integrator step — mathematically
    identical to the accumulated chain rule the reference hand-derives for RK4
    (`integration.hpp:154-168`), verified against its hardcoded A,B matrices
    in the test suite.
    """
    try:
        step = _INTEGRATORS[method]
    except KeyError:
        raise ValueError(
            f"Unknown integrator {method!r}; expected one of {sorted(_INTEGRATORS)}"
        ) from None
    cfn = model.fn

    def dfn(params, x, u, t, h):
        return step(cfn, params, x, u, t, h)

    return DiscreteModel(
        params=model.params,
        fn=dfn,
        n=model.n,
        m=model.m,
        name=f"{model.name}_{method}",
        continuous_fn=cfn,
        method=method,
    )
