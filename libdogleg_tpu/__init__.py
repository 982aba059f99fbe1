"""libdogleg_tpu — a nonlinear least-squares framework for accelerators.

A brand-new JAX/XLA/Pallas implementation of the problem class solved by
dkogan/libdogleg (see /root/reference, reference README.pod:17-38): find the
vector p (Nstate) minimizing norm2(f(p)) given a user function producing the
residual vector x (Nmeasurements) and its Jacobian J = dx/dp, via Powell's
dog-leg trust-region algorithm.

This is not a port: the architecture is accelerator-first. Every operating-point
evaluation is reduced once over the measurement axis into the products
(norm2(x), J^T x, J^T J) — a single matrix contraction — after which the
entire trust-region iteration is Nstate-sized math inside a jitted
`lax.while_loop`. Solves are vmappable (batched independent problems) and
shardable (measurement-axis row blocks with psum over a device mesh).
"""

from libdogleg_tpu.params import (
    DoglegParameters,
    get_default_parameters,
)
from libdogleg_tpu.solver import (
    Products,
    SolveResult,
    StopReason,
    StepType,
    init_solver_state,
    result_from_state,
    run_solver,
    solve_products,
)
from libdogleg_tpu.ops.newton import (
    DenseNewtonSolver,
    SchurJtJ,
    SchurNewtonSolver,
    SparseNewtonSolver,
)
from libdogleg_tpu.problems import (
    DenseProblem,
    FactoredBasisProblem,
    ProductsProblem,
    ResidualProblem,
    SparseProblem,
    optimize,
)
from libdogleg_tpu.ops.bcsr import BCSRStructure, BCSRJacobian
from libdogleg_tpu.ops.pallas_mega import megakernel_optimize
from libdogleg_tpu.sparsity import bcsr_from_scalar_csr

__all__ = [
    "DoglegParameters",
    "get_default_parameters",
    "Products",
    "SolveResult",
    "StopReason",
    "StepType",
    "solve_products",
    "init_solver_state",
    "run_solver",
    "result_from_state",
    "DenseNewtonSolver",
    "SchurNewtonSolver",
    "SchurJtJ",
    "SparseNewtonSolver",
    "DenseProblem",
    "FactoredBasisProblem",
    "SparseProblem",
    "ProductsProblem",
    "ResidualProblem",
    "optimize",
    "BCSRStructure",
    "BCSRJacobian",
    "bcsr_from_scalar_csr",
    "megakernel_optimize",
]

__version__ = "0.1.0"
