"""Backwards-compatible alias: the reference's sample.c demo problem now
lives in the model-family package as
libdogleg_tpu.models.quadratic_surface."""

from libdogleg_tpu.models.quadratic_surface import (  # noqa: F401
    GRID_DELTA,
    GRID_MIN,
    GRID_WIDTH,
    NMEAS,
    NSTATE,
    P_TRUE,
    factored_products,
    factored_products_lanes,
    factored_statistics,
    gram_pair,
    initial_state,
    jacobian,
    make_dense_problem,
    make_factored_problem,
    make_grid,
    make_products_problem,
    make_residual_problem,
    make_sparse_problem,
    model,
    products_lanes,
    residuals,
    simulate,
)
