"""Configuration dataclasses.

The reference has no config system (module constants + kwargs; SURVEY §5,
``/root/reference/block_7_main_ver3.py:332-344``). Here every layer takes a
frozen dataclass so configs are hashable and usable as jit static args.

Canonical defaults mirror the reference flagship run
(``block_7_main_ver3.py:332-344``): N=64, P=5 nodes, lam_tv=0.02, rho=2.0,
max_iters=200, eps_pri=eps_dual=1e-3, noise 0.005, knn k=2, seed 123,
q_mode="arithmetic".
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GeometryConfig:
    """Parallel-beam acquisition geometry.

    Mirrors the reference operator builder semantics
    (``/root/reference/block_2_load_odl_data.py:16-65``): image on
    [-1,1]^2 with N x N pixels, ``angles_total = max(180, 3N)`` split evenly
    over nodes (remainder to the first nodes), detector of N pixels spanning
    width ``det_width_factor * 2.0``, angles uniform on [0, pi).
    """

    N: int = 64
    num_nodes: int = 5
    angles_total: Optional[int] = None  # default: max(180, 3N)
    det_pixels: Optional[int] = None  # default: N
    det_width_factor: float = 1.0
    fan_beam: bool = False  # fan-beam geometry (config 5: 512^2, 32 nodes)
    src_radius: float = 4.0  # fan-beam only: source distance from center
    det_radius: float = 4.0  # fan-beam only: detector distance from center

    @property
    def n(self) -> int:
        return self.N * self.N

    @property
    def total_angles(self) -> int:
        if self.angles_total is not None:
            return self.angles_total
        return max(180, 3 * self.N)

    @property
    def n_det(self) -> int:
        return self.det_pixels if self.det_pixels is not None else self.N

    def angles_per_node(self) -> Tuple[int, ...]:
        """Even split with remainder to the first nodes
        (ref ``block_2_load_odl_data.py:36-38``)."""
        base = self.total_angles // self.num_nodes
        rem = self.total_angles % self.num_nodes
        return tuple(base + (1 if i < rem else 0) for i in range(self.num_nodes))


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Per-pixel communication-graph construction (ref block_3)."""

    strategy: str = "knn"  # "knn" | "mst" | "chain" | "complete"
    k: int = 2
    seed: int = 123
    q_mode: str = "arithmetic"  # "arithmetic" | "harmonic"


@dataclasses.dataclass(frozen=True)
class NodeSolverConfig:
    """Inexact node-subproblem solver (replaces CVXPY+SCS, ref block_5/6).

    The node update minimizes
        0.5||A_i x - b_i||^2 + lam_tv*TV(x) + (rho/2) sum_j ||x - v_ij||^2_{Q_ij}
    via the Condat-Vu primal-dual splitting (smooth LS+quadratic part by
    gradient, TV by its dual prox), warm-started across outer iterations.

    Inexactness mirrors the reference adaptive schedule
    (``block_6_admm_loop_ver2.py:100-108``): stationarity target
    eps_k = eps0 / (k+1)^(1+gamma_decay); the inner loop runs in chunks of
    ``check_every`` iterations until ||g|| <= eps_k or ``max_inner`` total.
    """

    max_inner: int = 200
    check_every: int = 10
    # Inner algorithm: "cv" = Condat-Vu (smooth LS part by gradient),
    # "fcv" = Condat-Vu in a per-node circulant (Fourier) metric — the CT
    # normal operator A^T A is near shift-invariant, so one 2-D transfer
    # function captures its spectral decay where diagonal preconditioners
    # cannot (core.node_solver.build_fourier_precond),
    # "pcv" = per-pixel SART/Jacobi preconditioned CV, "ppdhg" = diagonally
    # preconditioned PDHG (Pock-Chambolle steps from matrix-free |K|
    # row/column sums — the standard CT recipe), or "fista" = accelerated
    # proximal gradient with warm-started Chambolle TV prox and
    # gradient-restart momentum.
    algorithm: str = "cv"
    # Chambolle dual-ascent iterations per FISTA step (the prox warm-starts
    # from the node's TV dual field, so a handful suffice).
    fista_prox_iters: int = 8
    eps0: float = 2.0
    gamma_decay: float = 0.005
    sigma_scale: float = 1.0  # dual step scale relative to default
    warm_start: bool = True
    # Early exit when ||g|| stops improving between checks (all nodes):
    # relative decrease below this => the normalized-subgradient residual has
    # hit its floor and further inner iterations are wasted. SCS behaves the
    # same way (stops at its internal tolerance). 0 disables.
    plateau_tol: float = 0.01
    # DATA-SCALE-RELATIVE inexactness: widen the acceptance target to
    # eps_k = max(eps0, eps_rel * ||A_i^T b_i||) / (k+1)^(1+gamma) per node.
    # The reference's absolute eps0 was tuned at 64^2 and is unreachable at
    # 256^2+ (acceptance never fires there, the budget rules);
    # anchoring at the per-node data scale makes the adaptive schedule fire
    # at every problem size. 0 disables (reference-parity default).
    eps_rel: float = 0.0


@dataclasses.dataclass(frozen=True)
class AdmmConfig:
    """Outer consensus-ADMM loop (ref ``block_6_admm_loop_ver2.py:15-20``)."""

    lam_tv: float = 0.02
    rho: float = 2.0
    max_iters: int = 200
    eps_pri: float = 1e-3
    eps_dual: float = 1e-3
    z_fusion: str = "midpoint"  # "midpoint" (executed ref) | "weighted" (eq. 2)
    # Over-relaxation factor (Boyd sec. 3.4.3): x̂ = alpha*x + (1-alpha)*z in
    # the z/y updates; 1.0 = reference algorithm, 1.5-1.8 typically speeds
    # consensus convergence.
    relax_alpha: float = 1.0
    # Residual balancing (Boyd sec. 3.4.1): after each outer iteration,
    # rho *= rho_tau when ||r|| > rho_mu*||s||, rho /= rho_tau when
    # ||s|| > rho_mu*||r||, with the scaled duals Y rescaled by the inverse
    # factor. The effective rho is carried in AdmmState as a multiplier of
    # this config's rho, clamped to [1/rho_clamp, rho_clamp]. Off by
    # default (reference parity — the reference runs fixed rho,
    # block_6_admm_loop_ver2.py:19); the knob that classically attacks a
    # stalled dual residual (the spectral-gap-limited consensus of the
    # 32-node fan configuration).
    adapt_rho: bool = False
    rho_mu: float = 10.0
    rho_tau: float = 2.0
    rho_clamp: float = 64.0
    # Adaptation policy. "balance" = the classical residual-ratio scheme
    # above. "stall" = quality-signal variant (from a study of the 32-node
    # fan configuration): in the spectral-gap-limited many-node regime the
    # DUAL residual dominates, so balancing can only LOWER rho — yet the
    # measured quality lever there is HIGH rho (static rho=20 bought +4 dB). "stall" instead
    # raises rho by rho_tau whenever the primal residual has failed to
    # improve by rho_stall_tol (relative) over the last rho_stall_window
    # outer iterations (checked at that cadence, never lowered) — the
    # primal plateau is the observable signature of consensus diffusion
    # stalling, and unlike an image-MSE trend it needs no oracle phantom.
    adapt_rho_mode: str = "balance"  # "balance" | "stall"
    rho_stall_window: int = 10
    rho_stall_tol: float = 0.02
    node: NodeSolverConfig = dataclasses.field(default_factory=NodeSolverConfig)


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """Top-level experiment configuration."""

    geometry: GeometryConfig = dataclasses.field(default_factory=GeometryConfig)
    graph: GraphConfig = dataclasses.field(default_factory=GraphConfig)
    admm: AdmmConfig = dataclasses.field(default_factory=AdmmConfig)
    noise_level: float = 0.005
    noise_seed: int = 0
    phantom: str = "const"  # "const" | "rand" | "shepp"
    dtype: str = "float32"
    # Storage dtype of the fft-projector phase tables ("float32" |
    # "bfloat16"); bf16 halves the traffic that bounds the inner loop at
    # ~0.1% operator perturbation.
    fft_table_dtype: str = "float32"
