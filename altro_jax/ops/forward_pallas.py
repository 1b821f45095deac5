"""Fused forward-pass kernel (Pallas through Triton): closed-loop rollout + cost.

The XLA forward pass is two separate time scans (`solver/batched.py`:
`closed_loop_rollout` + `total_cost`); on the GPU every scan step launches
its own small fusions over `[·, B]` arrays, N of them per line-search try.
This kernel runs the whole try in one launch:

  * one solve per lane, one lane per thread: the grid runs over blocks of
    `block` lanes, and the time loop is a `lax.fori_loop` inside the kernel
    with the state, the cost accumulator and the guard flags as loop-carried
    registers.  Nothing is carried between grid programs.
  * each time step fuses: ū = u + K(x̄−x) + αd, the stage cost (quadratic
    closed form) + AL penalty terms of every constraint family active at
    that knot, the RK4/Euler dynamics step, and the rollout divergence guard
    (`ilqr.hpp:468-499` semantics: freeze the state on the first violation,
    record kStateLimit/kControlLimit).
  * the terminal cost and terminal-constraint AL terms are added after the
    loop, so the kernel's J equals `total_cost` of the trajectory it writes
    (same accumulation the reference does across `RolloutClosedLoop` +
    `Cost`, `ilqr.hpp:512-558`).

With α = 0 (and K = d = 0) the same program is the open-loop rollout + cost
(`ilqr.hpp:453-459`); a second instantiation without the divergence guard
matches the reference's unguarded open rollout.

Every small array of a solve is a NumPy object array of `(block,)` vectors
(`ops/lanes.py`), and the user's continuous dynamics are traced at their
per-lane shapes and interpreted element by element, so no value inside the
kernel has a non-power-of-two shape.

Problem params are passed two ways, decided PER LEAF at call time:
  * shared across the batch → the whole leaf, read as scalars;
  * per-instance (trailing batch axis vs the canonical shape, the
    `batch_axes` convention) → a `[..., block]` slice per program, read as
    lane vectors.
This is what lets the randomized fleet (per-instance obstacle layouts /
goal refs / dynamics scalars — BASELINE config 5) run on the fused kernels;
the reference is indifferent to which problem object each solve in its loop
uses (`perf/benchmark_unicycle.cpp:45-75`), and so is this kernel.  Kernel
variants are cached per (signature, batch width).

Eligibility (checked at build; the solver falls back to the XLA scans
otherwise): one shared-structure rk4/euler dynamics family whose continuous
fn uses only primitives `ops/lanes.py` can evaluate per lane, quadratic cost
families, canned constraint structures (goal / control bound / circle —
`problem/constraints.py` structure tags), contiguous knot ranges and
zero/negative-orthant cones.  Per-knot (stacked) cost params that are also
per-instance must cover the full knot range (`param_sig`).

Kernels compile for the GPU through Triton and run in interpret mode on the
CPU, which is how the test suite exercises them (`kernel_interpret`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..problem.constraints import Cone
from ..problem.costs import _quadcost_eval
from ..types import SolverStatus
from . import lanes

_UNSOLVED = int(SolverStatus.UNSOLVED)
_STATE_LIMIT = int(SolverStatus.STATE_LIMIT)
_CONTROL_LIMIT = int(SolverStatus.CONTROL_LIMIT)

# Interpret mode pays per grid program, not per lane: use wide blocks.
INTERPRET_BLOCK = 1024
# One lane per thread: a program narrower than a warp would leave threads
# idle, so narrow or odd batch widths are padded up to at least one warp.
GPU_MIN_BLOCK = 32

# param keys streamed per constraint structure kind
_STRUCT_KEYS = {
    "goal": ("xf",),
    "control_bound": ("lb", "ub"),
    "circle": ("cx", "cy", "r"),
}


class Ineligible(Exception):
    """Problem structure not supported by the fused kernel."""


def kernel_interpret(backend: str | None = None) -> bool:
    """How the Pallas kernels run on `backend` (default: JAX's default
    backend): compiled through Triton on "gpu" (False), interpreted on
    "cpu" (True).  Any other platform has no kernel route and raises, so a
    kernel option never silently runs interpreted on an accelerator."""
    backend = backend or jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise ValueError(
        f"the Pallas kernels (forward_pass='pallas', backward_pass='fused') "
        f"compile for 'gpu' and run interpreted on 'cpu'; backend "
        f"{backend!r} has neither route - use the 'scan' passes"
    )


def _contiguous(knots: np.ndarray) -> tuple[int, int]:
    if len(knots) == 0:
        raise Ineligible("empty knot range")
    if len(knots) > 1 and not np.all(np.diff(knots) == 1):
        raise Ineligible("non-contiguous knot range")
    return int(knots[0]), int(knots[-1])


def _kadd(J, comp, term):
    """Kahan-compensated accumulation step: the N-term sequential f32 sum
    would otherwise be noisier than XLA's tree reduction, and line-search
    acceptance compares J0 - J, a tiny difference of large numbers
    (`ilqr.hpp:528-542`)."""
    y = term - comp
    t = J + y
    comp = (t - J) - y
    return t, comp


class ForwardKernel:
    """Fused closed-loop-rollout + total-cost kernel for one problem.

    Build once per (CompiledProblem, SolverOptions); call per line-search
    try.  `__call__(params, al_pad, Z, K, d, alpha, check_bounds)` returns
    `(Xnext [N,n,B], Ubar [N,m,B], J [B], valid [B], status [B])` with the
    batch in the last axis, exactly matching the XLA pair
    (`closed_loop_rollout` then `total_cost`).
    """

    # Lanes per Triton program on the GPU, one lane per thread (128 lanes
    # are four warps).  Timed 32/64/128 on the parking fleet at B=4096 on
    # the H100: 0.75 / 0.61 / 0.56 ms per call (PERF.md).
    gpu_block = 128

    def __init__(
        self,
        prob,
        opts,
        *,
        interpret: bool = False,
        dtype=jnp.float32,
        block: int | None = None,
    ):
        self.prob = prob
        self.opts = opts
        self.interpret = interpret
        self.dtype = jnp.dtype(dtype)
        self.max_block = block or (
            INTERPRET_BLOCK if interpret else self.gpu_block
        )
        if self.max_block & (self.max_block - 1):
            raise ValueError(f"block {self.max_block} is not a power of two")
        N, n, m = prob.N, prob.n, prob.m
        self.N, self.n, self.m = N, n, m

        # ---------------- eligibility + static structure
        if len(prob.dynamics_families) != 1:
            raise Ineligible("multiple dynamics families")
        dyn = prob.dynamics_families[0]
        if not dyn.shared:
            raise Ineligible("per-knot dynamics params")
        if dyn.model is None or dyn.model.method not in ("rk4", "euler"):
            raise Ineligible("unknown integrator")
        self._cont_fn = dyn.model.continuous_fn
        self._method = dyn.model.method
        dyn_leaves = jax.tree_util.tree_leaves(prob.params.dynamics[0])
        self._dyn_leaf_shapes = [np.shape(l) for l in dyn_leaves]
        self._dyn_treedef = jax.tree_util.tree_structure(prob.params.dynamics[0])
        self._probe_dynamics()

        self._cost_fams = []
        for fi, fam in enumerate(prob.cost_families):
            if fam.fn is not _quadcost_eval:
                raise Ineligible("non-quadratic cost family")
            k0, k1 = _contiguous(fam.knots)
            self._cost_fams.append(
                dict(fi=fi, k0=k0, k1=k1, stacked=not fam.shared)
            )

        self._con_fams = []
        for fi, fam in enumerate(prob.constraint_families):
            con = fam.constraint
            if con is None or con.structure is None:
                raise Ineligible("opaque constraint fn")
            if not fam.shared:
                raise Ineligible("per-knot constraint params")
            if fam.cone not in (Cone.ZERO, Cone.NEGATIVE_ORTHANT):
                raise Ineligible("unsupported cone for fused kernel")
            k0, k1 = _contiguous(fam.knots)
            self._con_fams.append(
                dict(
                    fi=fi, k0=k0, k1=k1, p=fam.dim, cone=fam.cone,
                    structure=con.structure,
                    stage=k0 <= N - 1, terminal=k1 == N,
                )
            )

        # stacked (per-knot) cost params can be per-instance too, but only
        # when the family covers the full knot range, so that row k of the
        # stacked leaf is knot k
        self._stacked_full = {
            f"cost{f['fi']}_{p}": (f["k0"] == 0 and f["k1"] == N)
            for f in self._cost_fams
            if f["stacked"]
            for p in ("Q", "R", "H", "q", "r", "c")
        }
        self._kernels = {}

    def _dyn_param_structs(self):
        return jax.tree_util.tree_unflatten(
            self._dyn_treedef,
            [jax.ShapeDtypeStruct(s, self.dtype) for s in self._dyn_leaf_shapes],
        )

    def _probe_dynamics(self):
        """Ineligible unless the continuous fn has a per-lane rule for every
        primitive it uses (`lanes.probe`; nothing is executed)."""
        n, m, dt = self.n, self.m, self.dtype
        try:
            lanes.probe(
                lambda p, x, u, t: self._cont_fn(p, x, u, t),
                self._dyn_param_structs(),
                jax.ShapeDtypeStruct((n,), dt),
                jax.ShapeDtypeStruct((m,), dt),
                jax.ShapeDtypeStruct((), dt),
            )
        except NotImplementedError as e:
            raise Ineligible(f"continuous fn has no per-lane form: {e}")

    def block_for(self, B: int) -> int:
        """Lanes per program for batch width B: the smallest power of two
        covering B, capped at `max_block`, and on the GPU at least one warp
        (`GPU_MIN_BLOCK`).  A width that is not a multiple of it is padded
        (`_pad_lanes`)."""
        least = 1 if self.interpret else GPU_MIN_BLOCK
        return min(self.max_block, max(least, 1 << (B - 1).bit_length()))

    def _pad_lanes(self, arrays, sig: frozenset, B: int):
        """Pad the lane-axis inputs to a multiple of `block_for(B)` lanes by
        repeating the last lane (a real instance, so the padding lanes do
        finite work); returns (arrays, padded width)."""
        block = self.block_for(B)
        Bp = -(-B // block) * block
        if Bp == B:
            return arrays, B
        _, lane_mask = self._input_layout(sig)
        widen = lambda a: jnp.pad(
            a, [(0, 0)] * (a.ndim - 1) + [(0, Bp - B)], mode="edge"
        )
        return [widen(a) if lane else a for a, lane in zip(arrays, lane_mask)], Bp

    # ---------------------------------------------------------- param plumbing
    def _iter_params(self, params):
        """Yield (name, canonical_leaf, stacked, actual_leaf) for every
        problem param the kernel reads, in a fixed order (dynamics, costs,
        constraints) shared by `_specs` and `__call__`."""
        canon = self.prob.params
        dyn_c = jax.tree_util.tree_leaves(canon.dynamics[0])
        dyn_a = jax.tree_util.tree_leaves(params.dynamics[0])
        for i, (c, a) in enumerate(zip(dyn_c, dyn_a)):
            yield f"dyn{i}", c, False, a
        for f in self._cost_fams:
            fi = f["fi"]
            cp, ap = canon.costs[fi], params.costs[fi]
            for pname in ("Q", "R", "H", "q", "r", "c"):
                yield f"cost{fi}_{pname}", cp[pname], f["stacked"], ap[pname]
        for f in self._con_fams:
            fi = f["fi"]
            cp, ap = canon.constraints[fi], params.constraints[fi]
            for key in _STRUCT_KEYS[f["structure"][0]]:
                yield f"con{fi}_{key}", cp[key], False, ap[key]

    def param_sig(self, params) -> frozenset:
        """The per-instance signature of `params`: the set of param names
        carrying a trailing batch axis (the `batch_axes` convention).

        Raises Ineligible for layouts the kernel cannot read (per-knot
        stacked params that are ALSO per-instance on a partial knot range,
        or unexpected ranks) — the solver falls back to the XLA scans for
        those.
        """
        sig = set()
        for name, canon, stacked, leaf in self._iter_params(params):
            nd_c, nd_a = jnp.ndim(canon), jnp.ndim(leaf)
            if nd_a == nd_c + 1:
                if stacked and not self._stacked_full.get(name, False):
                    raise Ineligible(
                        "per-knot AND per-instance cost params on a "
                        "partial knot range"
                    )
                sig.add(name)
            elif nd_a != nd_c:
                raise Ineligible(f"unexpected rank for param {name!r}")
        return frozenset(sig)

    def _pacc(self, get, sig, name):
        """Accessor `acc(*idx)` for a shared-or-per-instance problem param:
        shared leaves read one scalar (scalars are passed as shape (1,)),
        per-instance leaves read the program's lane vector."""
        ref = get(name)
        if name in sig:
            return lambda *idx: ref[idx + (slice(None),)]
        return lambda *idx: ref[idx] if idx else ref[0]

    def _param_arrays(self, params, sig: frozenset) -> list:
        """Problem-param kernel inputs in `_iter_params` order."""
        arrays = []
        for name, canon, stacked, leaf in self._iter_params(params):
            a = jnp.asarray(leaf, self.dtype)
            arrays.append(a if (name in sig or a.ndim) else a.reshape(1))
        return arrays

    # ------------------------------------------------------------- specs
    def _specs(self, arrays, lane_mask, block):
        """BlockSpecs: lane-axis inputs (`lane_mask` True) are sliced to the
        program's `block` lanes, the rest are read whole."""

        def spec(a, lane):
            shape = a.shape
            if lane:
                nd = len(shape)
                return pl.BlockSpec(
                    shape[:-1] + (block,),
                    lambda b, nd=nd: (0,) * (nd - 1) + (b,),
                )
            nd = len(shape)
            return pl.BlockSpec(shape, lambda b, nd=nd: (0,) * nd)

        return [spec(a, l) for a, l in zip(arrays, lane_mask)]

    def _pallas_call(
        self, kernel, in_specs, out_specs, out_shape, grid, block, name
    ):
        # one lane per thread: block // 32 warps
        return pl.pallas_call(
            kernel,
            grid=grid,
            in_specs=in_specs,
            out_specs=out_specs,
            out_shape=out_shape,
            interpret=self.interpret,
            backend="triton",
            compiler_params=pltriton.CompilerParams(
                num_warps=max(1, block // 32), num_stages=1
            ),
            name=name,
        )

    # ------------------------------------------------------------- kernel
    def _dyn_params_in_kernel(self, get, sig, block):
        """The dynamics param tree as LaneArrays of lane vectors (shared
        leaves are broadcast once here, not at every use in the dynamics)."""
        leaves = []
        for i, shape in enumerate(self._dyn_leaf_shapes):
            acc = self._pacc(get, sig, f"dyn{i}")
            out = np.empty(shape, object)
            for idx in np.ndindex(shape):
                out[idx] = lanes.vec(acc(*idx), block, self.dtype)
            leaves.append(out)
        return jax.tree_util.tree_unflatten(self._dyn_treedef, leaves)

    def _cont(self, dyn_params, x, u, t):
        """Continuous dynamics per lane: x, u lists of vectors → LaneArray."""
        return lanes.call(
            lambda p, xx, uu, tt: self._cont_fn(p, xx, uu, tt),
            dyn_params,
            lanes.lane_array(list(x)),
            lanes.lane_array(list(u)),
            lanes.lane_array(t, shape=()),
        )

    def _lane_dyn_step(self, dyn_params, x, u, t, h):
        """One RK4/Euler step per lane; x, u lists of vectors → list."""
        n, width = self.n, x[0].shape[0]
        dt = self.dtype

        def f(xx, tt):
            return [lanes.vec(e, width, dt) for e in self._cont(dyn_params, xx, u, tt)]

        if self._method == "euler":
            k1 = f(x, t)
            return [x[i] + h * k1[i] for i in range(n)]
        k1 = f(x, t)
        k2 = f([x[i] + 0.5 * h * k1[i] for i in range(n)], t + 0.5 * h)
        k3 = f([x[i] + 0.5 * h * k2[i] for i in range(n)], t + 0.5 * h)
        k4 = f([x[i] + h * k3[i] for i in range(n)], t + h)
        return [
            x[i] + h * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i]) / 6.0
            for i in range(n)
        ]

    def _cost_acc(self, get, sig, f, pname):
        """Accessor `(row, *idx)` for one quadratic-cost param.  Shared
        params ignore `row`; stacked params read row `row` of the leaf
        (for per-instance stacked leaves, row k is knot k)."""
        fi = f["fi"]
        name = f"cost{fi}_{pname}"
        if not f["stacked"]:
            a = self._pacc(get, sig, name)
            return lambda row, *idx: a(*idx)
        ref = get(name)
        if name in sig:
            return lambda row, *idx: ref[(row,) + idx + (slice(None),)]
        return lambda row, *idx: ref[(row,) + idx]

    def _quad_readers(self, get, sig, f):
        """(Qv, Rv, Hv, qv, rv, cv) accessors for one quadratic cost family,
        each taking a leading `row` argument."""
        return tuple(
            self._cost_acc(get, sig, f, p) for p in ("Q", "R", "H", "q", "r", "c")
        )

    def _lane_quad(self, get, sig, f, x, u, row):
        """Quadratic cost per lane (scalar/vector param unroll)."""
        n, m = self.n, self.m
        Qv_, Rv_, Hv_, qv_, rv_, cv_ = self._quad_readers(get, sig, f)
        Qv = lambda i, j: Qv_(row, i, j)
        Rv = lambda i, j: Rv_(row, i, j)
        Hv = lambda i, j: Hv_(row, i, j)
        qv = lambda i: qv_(row, i)
        rv = lambda i: rv_(row, i)
        J = cv_(row) + jnp.zeros_like(x[0])
        for i in range(n):
            J += qv(i) * x[i]
            J += 0.5 * Qv(i, i) * x[i] * x[i]
            for j in range(i + 1, n):  # symmetric off-diagonals
                J += Qv(i, j) * x[i] * x[j]
        if u is not None:
            for i in range(m):
                J += rv(i) * u[i]
                J += 0.5 * Rv(i, i) * u[i] * u[i]
                for j in range(i + 1, m):
                    J += Rv(i, j) * u[i] * u[j]
            for i in range(n):
                for j in range(m):
                    J += Hv(i, j) * x[i] * u[j]
        return J

    @staticmethod
    def _comp_circle(dx, dy, r):
        """r² − dx² − dy² in compensated (double-f32) arithmetic, collapsed
        to a correctly-rounded f32.

        The plain f32 expression carries ~ε·O(r²) ABSOLUTE error from the
        cancelling squares; the AL machinery multiplies c by penalties up
        to 1e8 (`constraint_values.hpp:131-143`), so that floor becomes
        O(1) noise in the gradient and dual update — the cause of the
        obstacle fleets' f32 MAX_PENALTY residue.  Dekker-split squares +
        compensated summation make the error RELATIVE (~ε·|c|), which the
        penalty scaling cannot amplify.  ~20 extra flops per obstacle row.
        """
        split = 4097.0  # 2^12 + 1 (f32 Dekker split constant)

        def two_sq(a):
            t = a * split
            hi = t - (t - a)
            lo = a - hi
            sq = a * a
            err = ((hi * hi - sq) + 2.0 * hi * lo) + lo * lo
            return sq, err

        def two_diff(a, b):
            s = a - b
            bb = s - a
            err = (a - (s - bb)) - (b + bb)
            return s, err

        r2, r2e = two_sq(r + jnp.zeros_like(dx))
        x2, x2e = two_sq(dx)
        y2, y2e = two_sq(dy)
        s1, e1 = two_diff(r2, x2)
        s2, e2 = two_diff(s1, y2)
        return s2 + (((r2e - x2e) - y2e) + e1 + e2)

    def _lane_con_rows(self, get, sig, f, x, u):
        """Constraint rows [p] of lane vectors for one family."""
        fi = f["fi"]
        kind = f["structure"][0]
        if kind == "goal":
            xf = self._pacc(get, sig, f"con{fi}_xf")
            return [x[i] - xf(i) for i in range(self.n)]
        if kind == "control_bound":
            _, lo_idx, hi_idx = f["structure"]
            lb = self._pacc(get, sig, f"con{fi}_lb")
            ub = self._pacc(get, sig, f"con{fi}_ub")
            rows = [lb(j) - u[j] for j in lo_idx]
            rows += [u[j] - ub(j) for j in hi_idx]
            return rows
        # circle — compensated evaluation, see _comp_circle
        _, xi, yi = f["structure"]
        cx = self._pacc(get, sig, f"con{fi}_cx")
        cy = self._pacc(get, sig, f"con{fi}_cy")
        rr = self._pacc(get, sig, f"con{fi}_r")
        rows = []
        for o in range(f["p"]):
            dx = x[xi] - cx(o)
            dy = x[yi] - cy(o)
            rows.append(self._comp_circle(dx, dy, rr(o)))
        return rows

    @staticmethod
    def _al_value(cone, lam_rows, rho, c_rows):
        """(‖Π(λ−ρc)‖² − ‖λ‖²)/2ρ per lane (`constraint_values.hpp:111-119`)."""
        acc = None
        lam2 = None
        for lam, c in zip(lam_rows, c_rows):
            s = lam - rho * c
            proj = s if cone is Cone.ZERO else jnp.minimum(s, 0.0)
            term = proj * proj
            acc = term if acc is None else acc + term
            l2 = lam * lam
            lam2 = l2 if lam2 is None else lam2 + l2
        return (acc - lam2) / (2.0 * rho)

    def _gate(self, f, k, v):
        """Zero `v` at knots outside family `f`'s stage range."""
        lo, hi = f["k0"], min(f["k1"], self.N - 1)
        if lo == 0 and hi == self.N - 1:
            return v
        return jnp.where((k >= lo) & (k <= hi), v, 0.0)

    def _terminal_cost(self, get, sig, xN, J, comp):
        """Terminal cost + terminal-constraint AL terms into (J, comp)."""
        N, m = self.N, self.m
        for f in self._cost_fams:
            if f["k1"] == N:
                J, comp = _kadd(
                    J, comp, self._lane_quad(get, sig, f, xN, None, N - f["k0"])
                )
        for f in self._con_fams:
            if not f["terminal"]:
                continue
            fi = f["fi"]
            lam_rows = [get(f"lamT{fi}")[r, :] for r in range(f["p"])]
            rho = get(f"rhoT{fi}")[:]
            um = None
            if f["structure"][0] == "control_bound":
                um = [jnp.zeros_like(xN[0])] * m
            c_rows = self._lane_con_rows(get, sig, f, xN, um)
            J, comp = _kadd(J, comp, self._al_value(f["cone"], lam_rows, rho, c_rows))
        return J, comp

    def _make_kernel(self, check_bounds: bool, sig: frozenset, names, block):
        n, m, N = self.n, self.m, self.N
        opts = self.opts
        dt = self.dtype
        state_max2 = float(opts.state_max) ** 2
        control_max2 = float(opts.control_max) ** 2
        n_in = len(names)

        def kernel(*refs):
            in_refs = refs[:n_in]
            xn_ref, ub_ref, J_ref, valid_ref, status_ref = refs[n_in:]

            def get(name):
                return in_refs[names[name]]

            dyn_params = self._dyn_params_in_kernel(get, sig, block)
            th = get("th")
            alpha = get("alpha")[:]
            X, U, Kg, dg = get("X"), get("U"), get("K"), get("d")

            def body(k, carry):
                x, J, comp, valid, status = carry
                x = list(x)
                t_k = th[k, 0]
                h_k = th[k, 1]
                dx = [x[i] - X[k, i, :] for i in range(n)]
                ubar = []
                for j in range(m):
                    acc = U[k, j, :]
                    fb = Kg[k, j, 0, :] * dx[0]
                    for i in range(1, n):
                        fb = fb + Kg[k, j, i, :] * dx[i]
                    ubar.append(acc + fb + alpha * dg[k, j, :])

                # stage cost: quadratic families active at knot k
                for f in self._cost_fams:
                    if f["k0"] > N - 1:
                        continue
                    nk = f["k1"] - f["k0"] + 1
                    row = jnp.clip(k - f["k0"], 0, nk - 1)
                    Jc = self._lane_quad(get, sig, f, x, ubar, row)
                    J, comp = _kadd(J, comp, self._gate(f, k, Jc))

                # AL penalty terms of stage constraint families
                for f in self._con_fams:
                    if not f["stage"]:
                        continue
                    fi = f["fi"]
                    lam_rows = [get(f"lam{fi}")[k, r, :] for r in range(f["p"])]
                    rho = get(f"rho{fi}")[k, :]
                    c_rows = self._lane_con_rows(get, sig, f, x, ubar)
                    Jc = self._al_value(f["cone"], lam_rows, rho, c_rows)
                    J, comp = _kadd(J, comp, self._gate(f, k, Jc))

                xnext = self._lane_dyn_step(dyn_params, x, ubar, t_k, h_k)

                if check_bounds:
                    xn2 = xnext[0] * xnext[0]
                    for i in range(1, n):
                        xn2 = xn2 + xnext[i] * xnext[i]
                    un2 = ubar[0] * ubar[0]
                    for j in range(1, m):
                        un2 = un2 + ubar[j] * ubar[j]
                    state_ok = xn2 <= state_max2
                    ctrl_ok = un2 <= control_max2
                    step_ok = state_ok & ctrl_ok
                    fail_now = valid & ~step_ok
                    status = jnp.where(
                        fail_now,
                        jnp.where(state_ok, _CONTROL_LIMIT, _STATE_LIMIT),
                        status,
                    )
                    valid = valid & step_ok
                    x = [jnp.where(valid, xnext[i], x[i]) for i in range(n)]
                else:
                    x = xnext

                for i in range(n):
                    xn_ref[k, i, :] = x[i]
                for j in range(m):
                    ub_ref[k, j, :] = ubar[j]
                return tuple(x), J, comp, valid, status

            zero = jnp.zeros((block,), dt)
            x0 = get("x0")
            init = (
                tuple(x0[i, :] for i in range(n)),
                zero,
                zero,
                jnp.ones((block,), jnp.bool_),
                jnp.full((block,), _UNSOLVED, jnp.int32),
            )
            x, J, comp, valid, status = lax.fori_loop(0, N, body, init)
            J, comp = self._terminal_cost(get, sig, list(x), J, comp)
            J_ref[:] = J - comp
            valid_ref[:] = valid.astype(jnp.int32)
            status_ref[:] = status

        return kernel

    # lane-axis trajectory inputs, in call order
    _traj_inputs = ("x0", "alpha", "X", "U", "K", "d")

    def _input_layout(self, sig: frozenset):
        """(names, lane_mask) of the kernel inputs in call order."""
        names, lane = {}, []

        def add(name, is_lane):
            names[name] = len(lane)
            lane.append(is_lane)

        add("th", False)  # [N+1, 2] times / steps (row N: t_N, 0)
        for name, _, _, _ in self._iter_params(self.prob.params):
            add(name, name in sig)
        for name in self._traj_inputs:
            add(name, True)
        for f in self._con_fams:
            fi = f["fi"]
            if f["stage"]:
                add(f"lam{fi}", True)
                add(f"rho{fi}", True)
            if f["terminal"]:
                add(f"lamT{fi}", True)
                add(f"rhoT{fi}", True)
        return names, lane

    def _get_call(self, check_bounds: bool, B: int, sig: frozenset, arrays):
        key = (check_bounds, B, sig)
        if key not in self._kernels:
            n, m, N = self.n, self.m, self.N
            block = self.block_for(B)
            names, lane_mask = self._input_layout(sig)
            lane_out = lambda *dims: pl.BlockSpec(
                dims + (block,), lambda b, nd=len(dims): (0,) * nd + (b,)
            )
            self._kernels[key] = self._pallas_call(
                self._make_kernel(check_bounds, sig, names, block),
                in_specs=self._specs(arrays, lane_mask, block),
                out_specs=[
                    lane_out(N, n), lane_out(N, m), lane_out(), lane_out(),
                    lane_out(),
                ],
                out_shape=[
                    jax.ShapeDtypeStruct((N, n, B), self.dtype),
                    jax.ShapeDtypeStruct((N, m, B), self.dtype),
                    jax.ShapeDtypeStruct((B,), self.dtype),
                    jax.ShapeDtypeStruct((B,), jnp.int32),
                    jax.ShapeDtypeStruct((B,), jnp.int32),
                ],
                grid=(B // block,),
                block=block,
                name="altro_forward",
            )
        return self._kernels[key]

    # ------------------------------------------------------------- call
    def pad_al(self, al):
        """Pad per-family AL state to full stage/terminal buffers.

        Returns a list aligned with `self._con_fams` of dicts with
        `lam` [N,p,B] / `rho` [N,B] (stage, zero/one padded) and
        `lamT` [p,B] / `rhoT` [B] (terminal).  Call once per inner solve —
        duals and penalties are constant within it.
        """
        N = self.N
        out = []
        for f, st in zip(self._con_fams, al):
            lam, rho = st["lam"], st["rho"]
            B = rho.shape[-1]
            d = {}
            if f["stage"]:
                hi = min(f["k1"], N - 1)
                nk_stage = hi - f["k0"] + 1
                lam_s = jnp.zeros((N, f["p"], B), lam.dtype)
                rho_s = jnp.ones((N, B), rho.dtype)
                lam_s = lam_s.at[f["k0"] : hi + 1].set(lam[:nk_stage])
                rho_s = rho_s.at[f["k0"] : hi + 1].set(rho[:nk_stage])
                d["lam"] = lam_s
                d["rho"] = rho_s
            if f["terminal"]:
                d["lamT"] = lam[-1]
                d["rhoT"] = rho[-1]
            out.append(d)
        return out

    def _th(self, Z):
        return jnp.stack(
            [Z.t, jnp.concatenate([Z.h, jnp.zeros((1,), Z.h.dtype)])], axis=-1
        ).astype(self.dtype)

    def _al_arrays(self, al_pad) -> list:
        arrays = []
        for f, pad in zip(self._con_fams, al_pad):
            if f["stage"]:
                arrays += [pad["lam"], pad["rho"]]
            if f["terminal"]:
                arrays += [pad["lamT"], pad["rhoT"]]
        return [jnp.asarray(a, self.dtype) for a in arrays]

    def __call__(self, params, al_pad, Z, K, d, alpha, *, check_bounds=True):
        n = self.n
        B = Z.X.shape[-1]
        dt = self.dtype
        sig = self.param_sig(params)
        x0 = params.x0
        if x0.ndim == 1:
            x0 = jnp.broadcast_to(x0[:, None], (n, B))
        alpha = jnp.asarray(alpha, dt)
        if alpha.ndim == 0:
            alpha = jnp.broadcast_to(alpha, (B,))
        arrays = [self._th(Z)]
        arrays += self._param_arrays(params, sig)
        arrays += [jnp.asarray(a, dt) for a in (x0, alpha, Z.X[:-1], Z.U, K, d)]
        arrays += self._al_arrays(al_pad)
        arrays, Bp = self._pad_lanes(arrays, sig, B)
        call = self._get_call(check_bounds, Bp, sig, arrays)
        Xn, Ubar, J, valid, status = (o[..., :B] for o in call(*arrays))
        return Xn, Ubar, J, valid > 0, status


def build_forward_kernel(prob, opts, *, interpret: bool = False, dtype=jnp.float32):
    """Build the fused kernel, or return None if the problem is ineligible."""
    try:
        return ForwardKernel(prob, opts, interpret=interpret, dtype=dtype)
    except Ineligible:
        return None
