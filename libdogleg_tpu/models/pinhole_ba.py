"""Nonlinear pinhole-camera bundle adjustment: the flagship real workload.

libdogleg was written for camera calibration / structure-from-motion
(reference README.pod:5-15; its companion project mrcal). This model is
that problem in its standard form: ncam pinhole cameras with axis-angle
pose (6 dof each) observing npts 3-D points; residuals are 2-D
reprojection errors. States:

    p = {"c": (ncam * 6,) camera poses, "q": (npts, 3) points}

Every observation's (2, 6) camera Jacobian and (2, 3) point Jacobian comes
from forward-mode autodiff of the projection (vmapped over observations) —
hand-deriving them is the error-prone step the C workflow needs
dogleg_testGradient for. The arrow system (SchurJtJ) is assembled with
segment-sums over observations, so the solve runs through
TreeSchurNewtonSolver: batched 3x3 point eliminations + one dense reduced
camera system, shardable over a 'pts' mesh axis like
models.bundle_adjustment.

Gauge freedom (global similarity) is fixed the standard way: the first
camera's pose is pinned by a strong prior residual, and a weak prior on
all points controls the scale/depth ambiguity.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from libdogleg_tpu.ops.newton import SchurJtJ, TreeSchurNewtonSolver
from libdogleg_tpu.solver import Products


def rodrigues(r, v):
    """Rotate v by the axis-angle vector r (Rodrigues), autodiff-safe at
    r -> 0 via the expanded small-angle form."""
    theta2 = jnp.dot(r, r)
    theta = jnp.sqrt(theta2 + 1e-24)
    k = r / theta
    c, s = jnp.cos(theta), jnp.sin(theta)
    rotated = (v * c + jnp.cross(k, v) * s
               + k * jnp.dot(k, v) * (1.0 - c))
    return jnp.where(theta2 < 1e-16, v + jnp.cross(r, v), rotated)


def project(cam, point, focal):
    """Pinhole projection of one 3-D point through one camera.
    cam = (rvec(3), tvec(3)); returns (2,) pixel coordinates."""
    pc = rodrigues(cam[:3], point) + cam[3:]
    return focal * pc[:2] / pc[2]


class PinholeBA(NamedTuple):
    ncam: int
    npts: int
    focal: float
    cam_idx: jnp.ndarray     # (nobs,) camera of each observation
    pt_idx: jnp.ndarray      # (nobs,) point of each observation
    obs: jnp.ndarray         # (nobs, 2) observed pixels
    w_prior_cam0: float      # pins camera 0 (gauge)
    w_prior_pts: float       # weak depth/scale prior
    cam0_prior: jnp.ndarray  # (6,) the pose camera 0 is pinned to
    pts_prior: jnp.ndarray   # (npts, 3) prior point positions
    p_true: dict             # generating state {"c", "q"}

    @property
    def nobs(self) -> int:
        return int(self.obs.shape[0])

    @property
    def nstate(self) -> int:
        return self.ncam * 6 + self.npts * 3

    def residuals_obs(self, p):
        cams = p["c"].reshape(self.ncam, 6)
        proj = jax.vmap(lambda ci, qi: project(cams[ci], qi, self.focal))(
            self.cam_idx, p["q"][self.pt_idx])
        return (proj - self.obs).reshape(-1)

    @property
    def _dense_grid(self) -> bool:
        """True when the observations form the canonical cam-major full
        visibility grid (every camera sees every point, make_synthetic's
        layout) — enables the scatter-free products path. Traced index
        fields (an instance vmapped over / passed as a jitted argument)
        cannot be inspected at trace time: fall back to the generic
        scatter path, which is fully traceable."""
        if isinstance(self.cam_idx, jax.core.Tracer) or isinstance(
                self.pt_idx, jax.core.Tracer):
            return False
        ci = np.asarray(self.cam_idx)
        if ci.shape[0] != self.ncam * self.npts:
            return False
        pi = np.asarray(self.pt_idx)
        return bool(
            (ci == np.repeat(np.arange(self.ncam), self.npts)).all()
            and (pi == np.tile(np.arange(self.npts), self.ncam)).all())

    def _products_grid(self, p) -> Products:
        """Scatter-free arrow-system assembly over the (ncam, npts) grid.

        The generic path below scatters 640k (6,3)/(3,3)/(6,6) blocks into
        U/V/W, and scatter-adds were the bench-config-7 bottleneck on the
        accelerator this library was first built for. With full visibility every (cam, point)
        pair exists, so every reduction is a dense einsum and W is a
        transpose — no scatters at all."""
        dt = p["c"].dtype
        cams = p["c"].reshape(self.ncam, 6)
        q = p["q"]
        obs_g = self.obs.reshape(self.ncam, self.npts, 2)

        def jac_pair(cam, point, ob):
            r = project(cam, point, self.focal) - ob
            Jc = jax.jacfwd(lambda c: project(c, point, self.focal))(cam)
            Jq = jax.jacfwd(lambda s: project(cam, s, self.focal))(point)
            return r, Jc, Jq

        r, Jc, Jq = jax.vmap(jax.vmap(jac_pair, in_axes=(None, 0, 0)),
                             in_axes=(0, None, 0))(cams, q, obs_g)
        # r (ncam, npts, 2); Jc (ncam, npts, 2, 6); Jq (ncam, npts, 2, 3)

        nc = self.ncam * 6
        w0 = jnp.asarray(self.w_prior_cam0, dt)
        wp = jnp.asarray(self.w_prior_pts, dt)
        r_cam0 = jnp.sqrt(w0) * (p["c"][:6] - self.cam0_prior)
        r_pts = jnp.sqrt(wp) * (q - self.pts_prior)
        norm2_x = (jnp.sum(r * r) + jnp.dot(r_cam0, r_cam0)
                   + jnp.sum(r_pts * r_pts))

        gc = jnp.einsum('cpij,cpi->cj', Jc, r,
                        preferred_element_type=dt).reshape(nc)
        gc = gc.at[:6].add(w0 * (p["c"][:6] - self.cam0_prior))
        gq = jnp.einsum('cpij,cpi->pj', Jq, r,
                        preferred_element_type=dt) + wp * (q - self.pts_prior)

        U_blk = jnp.einsum('cpij,cpik->cjk', Jc, Jc,
                           preferred_element_type=dt)
        U = jax.scipy.linalg.block_diag(
            *[U_blk[i] for i in range(self.ncam)])
        U = U.at[:6, :6].add(w0 * jnp.eye(6, dtype=dt))

        V = jnp.einsum('cpij,cpik->pjk', Jq, Jq,
                       preferred_element_type=dt) + wp * jnp.eye(3, dtype=dt)

        W = jnp.einsum('cpij,cpik->cjpk', Jc, Jq,
                       preferred_element_type=dt).reshape(nc, self.npts, 3)

        return Products(norm2_x=norm2_x,
                        Jt_x={"c": gc, "q": gq},
                        JtJ=SchurJtJ(U=U, W=W, V=V))

    def products(self, p) -> Products:
        """Per-observation autodiff Jacobians -> arrow system by
        segment-sum. The camera block U is block-diagonal by camera but
        assembled dense (nc is small); W/V are per-point. Full-visibility
        instances take the scatter-free grid path (_products_grid)."""
        if self._dense_grid:
            return self._products_grid(p)
        dt = p["c"].dtype
        cams = p["c"].reshape(self.ncam, 6)
        q = p["q"]

        def res_one(cam, point, ob):
            return project(cam, point, self.focal) - ob

        def jac_one(ci, pi, ob):
            cam, point = cams[ci], q[pi]
            r = res_one(cam, point, ob)
            Jc = jax.jacfwd(lambda c: res_one(c, point, ob))(cam)  # (2,6)
            Jq = jax.jacfwd(lambda s: res_one(cam, s, ob))(point)  # (2,3)
            return r, Jc, Jq

        r, Jc, Jq = jax.vmap(jac_one)(self.cam_idx, self.pt_idx, self.obs)

        nc = self.ncam * 6
        # gauge prior on camera 0 + weak point prior
        w0 = jnp.asarray(self.w_prior_cam0, dt)
        wp = jnp.asarray(self.w_prior_pts, dt)
        r_cam0 = jnp.sqrt(w0) * (p["c"][:6] - self.cam0_prior)
        r_pts = jnp.sqrt(wp) * (q - self.pts_prior)

        norm2_x = (jnp.sum(r * r) + jnp.dot(r_cam0, r_cam0)
                   + jnp.sum(r_pts * r_pts))

        # gradient
        gc_obs = jnp.zeros((self.ncam, 6), dt).at[self.cam_idx].add(
            jnp.einsum('oij,oi->oj', Jc, r))
        gc = gc_obs.reshape(nc).at[:6].add(
            w0 * (p["c"][:6] - self.cam0_prior))
        gq = jnp.zeros((self.npts, 3), dt).at[self.pt_idx].add(
            jnp.einsum('oij,oi->oj', Jq, r)) + wp * (q - self.pts_prior)

        # U: per-camera 6x6 blocks -> dense (nc, nc)
        U_blk = jnp.zeros((self.ncam, 6, 6), dt).at[self.cam_idx].add(
            jnp.einsum('oij,oik->ojk', Jc, Jc))
        U = jax.scipy.linalg.block_diag(
            *[U_blk[i] for i in range(self.ncam)])
        U = U.at[:6, :6].add(w0 * jnp.eye(6, dtype=dt))

        # V: per-point 3x3 + weak prior
        V = jnp.zeros((self.npts, 3, 3), dt).at[self.pt_idx].add(
            jnp.einsum('oij,oik->ojk', Jq, Jq))
        V = V + wp * jnp.eye(3, dtype=dt)

        # W: (nc, npts, 3) coupling — scatter per observation into the
        # observing camera's 6-row slice
        Wc = jnp.zeros((self.ncam, 6, self.npts, 3), dt)
        Wc = Wc.at[self.cam_idx, :, self.pt_idx].add(
            jnp.einsum('oij,oik->ojk', Jc, Jq))
        W = Wc.reshape(nc, self.npts, 3)

        return Products(norm2_x=norm2_x,
                        Jt_x={"c": gc, "q": gq},
                        JtJ=SchurJtJ(U=U, W=W, V=V))

    def newton_solver(self) -> TreeSchurNewtonSolver:
        # default (unrolled) point solver: with the scatter-free grid
        # products, bench config 7 measures 91 ms unrolled vs 161 ms lax
        # (in the old scatter-products regime the ordering was reversed —
        # see ops/newton.SchurNewtonSolver.point_solver).
        return TreeSchurNewtonSolver(nc=self.ncam * 6, n_points=self.npts,
                                     block_size=3)

    def p0(self, key=None, jitter: float = 0.0, dtype=None):
        """Initial state: the prior points and zero poses (plus optional
        jitter on top of the TRUE state for basin-of-convergence tests)."""
        dtype = dtype or self.obs.dtype
        if jitter:
            k1, k2 = jax.random.split(key)
            return {
                "c": (self.p_true["c"].astype(dtype)
                      + jitter * jax.random.normal(
                          k1, self.p_true["c"].shape, dtype)),
                "q": (self.p_true["q"].astype(dtype)
                      + jitter * jax.random.normal(
                          k2, self.p_true["q"].shape, dtype))}
        c0 = jnp.zeros((self.ncam * 6,), dtype)
        c0 = c0.at[:6].set(self.cam0_prior.astype(dtype))
        return {"c": c0, "q": self.pts_prior.astype(dtype)}


def make_synthetic(seed: int = 0, ncam: int = 6, npts: int = 200,
                   focal: float = 500.0, pixel_noise: float = 0.5,
                   dtype=jnp.float64) -> PinholeBA:
    """Cameras on a ring looking at a point cloud near the origin; every
    camera observes every point (dense visibility)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(npts, 3)) * np.array([2.0, 2.0, 0.5])
    cams = []
    for i in range(ncam):
        ang = 2 * np.pi * i / ncam
        # small rotation jitter; translation places the camera so points
        # sit at depth ~6 in front of it
        rvec = rng.normal(size=3) * 0.05
        tvec = np.array([1.5 * np.cos(ang), 1.5 * np.sin(ang), 6.0])
        cams.append(np.concatenate([rvec, tvec]))
    cams = np.asarray(cams)

    cam_idx = np.repeat(np.arange(ncam), npts)
    pt_idx = np.tile(np.arange(npts), ncam)

    obs = []
    for ci, pi in zip(cam_idx, pt_idx):
        r, t = cams[ci, :3], cams[ci, 3:]
        theta = np.linalg.norm(r)
        if theta < 1e-12:
            pc = pts[pi] + t
        else:
            k = r / theta
            v = pts[pi]
            pc = (v * np.cos(theta) + np.cross(k, v) * np.sin(theta)
                  + k * np.dot(k, v) * (1 - np.cos(theta))) + t
        obs.append(focal * pc[:2] / pc[2])
    obs = np.asarray(obs) + rng.normal(size=(len(cam_idx), 2)) * pixel_noise

    return PinholeBA(
        ncam=ncam, npts=npts, focal=focal,
        cam_idx=jnp.asarray(cam_idx), pt_idx=jnp.asarray(pt_idx),
        obs=jnp.asarray(obs, dtype),
        w_prior_cam0=1e6, w_prior_pts=1e-4,
        cam0_prior=jnp.asarray(cams[0], dtype),
        pts_prior=jnp.asarray(pts, dtype),
        p_true={"c": jnp.asarray(cams.reshape(-1), dtype),
                "q": jnp.asarray(pts, dtype)})


# ---------------------------------------------------------------------------
# Sparse visibility: each point observed by only k_obs of the cameras — the
# realistic large-scale BA regime, where the dense coupling matrix W of
# SchurJtJ is infeasible (460 MB at ncam=128, npts=50000, bs=3) and the
# SparseWSchurJtJ form stores exactly the k_obs nonzero blocks per point.

from libdogleg_tpu.ops.newton import (SparseWSchurJtJ,  # noqa: E402
                                      SparseWSchurNewtonSolver)


class SparseVisibilityPinholeBA(NamedTuple):
    """Pinhole BA with point-major regular sparse visibility: point p is
    observed by cameras cam_of[p, :] (up to k_obs each). All products
    are scatter-free: per-point reductions are dense einsums over the
    (npts, k_obs) grid; camera-axis reductions are one-hot einsums;
    camera-axis broadcasts are gathers (see SparseWSchurNewtonSolver).

    VARIABLE visibility (different observation counts per point) is
    expressed by padding to k_obs slots and zeroing the extras via
    obs_mask: masked slots contribute exactly nothing to any product
    (their residual and Jacobian rows are zeroed before every reduction),
    so the solve equals the unpadded problem's. Pass the true measurement
    count to analysis scale computations yourself in that case."""
    ncam: int
    npts: int
    k_obs: int
    focal: float
    cam_of: jnp.ndarray      # (npts, k_obs) int32
    obs: jnp.ndarray         # (npts, k_obs, 2)
    w_prior_cam0: float
    w_prior_pts: float
    cam0_prior: jnp.ndarray  # (6,)
    pts_prior: jnp.ndarray   # (npts, 3)
    p_true: dict
    obs_mask: jnp.ndarray = None  # (npts, k_obs) {0,1}; None = all live

    @property
    def nobs(self) -> int:
        return self.npts * self.k_obs

    @property
    def nstate(self) -> int:
        return self.ncam * 6 + self.npts * 3

    def products(self, p) -> Products:
        dt = p["c"].dtype
        cams = p["c"].reshape(self.ncam, 6)
        q = p["q"]
        cam_g = cams[self.cam_of]                        # (npts, k_obs, 6)

        def jac_pair(cam, point, ob):
            r = project(cam, point, self.focal) - ob
            Jc = jax.jacfwd(lambda c: project(c, point, self.focal))(cam)
            Jq = jax.jacfwd(lambda s: project(cam, s, self.focal))(point)
            return r, Jc, Jq

        r, Jc, Jq = jax.vmap(jax.vmap(jac_pair, in_axes=(0, None, 0)))(
            cam_g, q, self.obs)
        # r (npts, k_obs, 2); Jc (..., 2, 6); Jq (..., 2, 3)
        if self.obs_mask is not None:
            m = self.obs_mask[..., None].astype(dt)
            r = r * m
            Jc = Jc * m[..., None]
            Jq = Jq * m[..., None]

        nc = self.ncam * 6
        w0 = jnp.asarray(self.w_prior_cam0, dt)
        wp = jnp.asarray(self.w_prior_pts, dt)
        r_cam0 = jnp.sqrt(w0) * (p["c"][:6] - self.cam0_prior)
        r_pts = jnp.sqrt(wp) * (q - self.pts_prior)
        norm2_x = (jnp.sum(r * r) + jnp.dot(r_cam0, r_cam0)
                   + jnp.sum(r_pts * r_pts))

        from libdogleg_tpu.ops.newton import onehot_cam_reduce
        gc = onehot_cam_reduce(
            self.cam_of,
            jnp.einsum('pkij,pki->pkj', Jc, r, preferred_element_type=dt),
            self.ncam).reshape(nc)
        gc = gc.at[:6].add(w0 * (p["c"][:6] - self.cam0_prior))
        gq = jnp.einsum('pkij,pki->pj', Jq, r,
                        preferred_element_type=dt) + wp * (q - self.pts_prior)

        U_blk = onehot_cam_reduce(
            self.cam_of,
            jnp.einsum('pkij,pkim->pkjm', Jc, Jc,
                       preferred_element_type=dt),
            self.ncam)                                   # (ncam, 6, 6)
        U = jax.scipy.linalg.block_diag(
            *[U_blk[i] for i in range(self.ncam)])
        U = U.at[:6, :6].add(w0 * jnp.eye(6, dtype=dt))

        V = jnp.einsum('pkij,pkim->pjm', Jq, Jq,
                       preferred_element_type=dt) + wp * jnp.eye(3, dtype=dt)
        Wv = jnp.einsum('pkij,pkim->pkjm', Jc, Jq,
                        preferred_element_type=dt)       # (npts, k_obs, 6, 3)

        return Products(norm2_x=norm2_x,
                        Jt_x={"c": gc, "q": gq},
                        JtJ=SparseWSchurJtJ(U=U, Wv=Wv, cam_of=self.cam_of,
                                            V=V))

    def dense_w_products(self, p) -> Products:
        """The same system with W densified into a SchurJtJ — the
        equivalence oracle for tests (and the memory-infeasible form this
        model exists to avoid)."""
        pr = self.products(p)
        J = pr.JtJ
        nc = self.ncam * 6
        Wc = jnp.zeros((self.ncam, 6, self.npts, 3), J.U.dtype)
        pidx = jnp.broadcast_to(jnp.arange(self.npts)[:, None],
                                self.cam_of.shape)
        Wc = Wc.at[self.cam_of, :, pidx].add(J.Wv)
        from libdogleg_tpu.ops.newton import SchurJtJ
        return Products(norm2_x=pr.norm2_x, Jt_x=pr.Jt_x,
                        JtJ=SchurJtJ(U=J.U, W=Wc.reshape(nc, self.npts, 3),
                                     V=J.V))

    def observation_jacobians(self, p):
        """(r, Jc, Jq) per observation — the inputs of the BA-scale
        outlierness pass (analysis.get_outlierness_factors_ba). Masked
        (padded) slots come back zeroed."""
        cams = p["c"].reshape(self.ncam, 6)
        cam_g = cams[self.cam_of]

        def jac_pair(cam, point, ob):
            r = project(cam, point, self.focal) - ob
            Jc = jax.jacfwd(lambda c: project(c, point, self.focal))(cam)
            Jq = jax.jacfwd(lambda s: project(cam, s, self.focal))(point)
            return r, Jc, Jq

        r, Jc, Jq = jax.vmap(jax.vmap(jac_pair, in_axes=(0, None, 0)))(
            cam_g, p["q"], self.obs)
        if self.obs_mask is not None:
            m = self.obs_mask[..., None].astype(r.dtype)
            r, Jc, Jq = r * m, Jc * m[..., None], Jq * m[..., None]
        return r, Jc, Jq

    def newton_solver(self) -> SparseWSchurNewtonSolver:
        return SparseWSchurNewtonSolver(nc=self.ncam * 6,
                                        n_points=self.npts,
                                        block_size=3, k_obs=self.k_obs)

    def p0(self, key=None, jitter: float = 0.0, dtype=None):
        dtype = dtype or self.obs.dtype
        if jitter:
            k1, k2 = jax.random.split(key)
            return {
                "c": (self.p_true["c"].astype(dtype)
                      + jitter * jax.random.normal(
                          k1, self.p_true["c"].shape, dtype)),
                "q": (self.p_true["q"].astype(dtype)
                      + jitter * jax.random.normal(
                          k2, self.p_true["q"].shape, dtype))}
        c0 = jnp.zeros((self.ncam * 6,), dtype)
        c0 = c0.at[:6].set(self.cam0_prior.astype(dtype))
        return {"c": c0, "q": self.pts_prior.astype(dtype)}


def make_synthetic_sparse(seed: int = 0, ncam: int = 16, npts: int = 1000,
                          k_obs: int = 4, focal: float = 500.0,
                          pixel_noise: float = 0.5,
                          dtype=jnp.float64) -> SparseVisibilityPinholeBA:
    """Ring of cameras, each point seen by k_obs consecutive cameras
    nearest its azimuth (a realistic covisibility band)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(npts, 3)) * np.array([2.0, 2.0, 0.5])
    cams = []
    for i in range(ncam):
        ang = 2 * np.pi * i / ncam
        rvec = rng.normal(size=3) * 0.05
        tvec = np.array([1.5 * np.cos(ang), 1.5 * np.sin(ang), 6.0])
        cams.append(np.concatenate([rvec, tvec]))
    cams = np.asarray(cams)

    az = np.arctan2(pts[:, 1], pts[:, 0])
    base = np.round(az / (2 * np.pi) * ncam).astype(int)
    cam_of = (base[:, None] + np.arange(k_obs)[None, :]) % ncam

    def np_project(cam, pt):
        r, t = cam[:3], cam[3:]
        theta = np.linalg.norm(r)
        if theta < 1e-12:
            pc = pt + t
        else:
            k = r / theta
            pc = (pt * np.cos(theta) + np.cross(k, pt) * np.sin(theta)
                  + k * np.dot(k, pt) * (1 - np.cos(theta))) + t
        return focal * pc[:2] / pc[2]

    obs = np.zeros((npts, k_obs, 2))
    for pi in range(npts):
        for kk in range(k_obs):
            obs[pi, kk] = np_project(cams[cam_of[pi, kk]], pts[pi])
    obs = obs + rng.normal(size=obs.shape) * pixel_noise

    return SparseVisibilityPinholeBA(
        ncam=ncam, npts=npts, k_obs=k_obs, focal=focal,
        cam_of=jnp.asarray(cam_of, jnp.int32),
        obs=jnp.asarray(obs, dtype),
        w_prior_cam0=1e6, w_prior_pts=1e-4,
        cam0_prior=jnp.asarray(cams[0], dtype),
        pts_prior=jnp.asarray(pts, dtype),
        p_true={"c": jnp.asarray(cams.reshape(-1), dtype),
                "q": jnp.asarray(pts, dtype)})
