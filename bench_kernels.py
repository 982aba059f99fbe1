"""Hot-kernel microbenchmarks with roofline shares, on one GPU.

Each row times one kernel the solver spends its time in and divides by
the relevant bound of the device it ran on:

  * large matmul (calibration)                       — f32 matrix-unit bound
  * batched small Cholesky (the batched-solve kernel) — memory bound
  * JtJ formation (the per-attempt contraction)       — memory bound at n=6
  * large dense Cholesky (lax.linalg vs largechol)    — f32 matrix-unit bound
  * batched mid-size Cholesky (blockchol vs lax)      — memory bound
  * block-sparse level-scheduled Cholesky             — factorizations/s
    (its bound is the elimination-tree critical path, not a roofline)

Timing is a host clock around block_until_ready (utils/benchtime.py). The
peaks are published figures of the card at its maximum power (see PEAKS);
a device not in the table is an error. The first line names the card and
its power limit; then one JSON line per kernel, each naming the device
and the power limit, and flagging `below_peaks_power` when the card is
set below the power the peaks assume (its shares are then of rates it
cannot reach).

    python bench_kernels.py
"""

import json
import sys
import time

from libdogleg_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from libdogleg_tpu.utils.benchtime import (card_line,  # noqa: E402
                                            measure, power_limit_w)

# device_kind -> (f32 matrix TFLOP/s, device memory GB/s). NVIDIA H100 SXM
# data sheet, dense rates: 495 TF32 tensor-core TFLOP/s (what a default-
# precision f32 matmul may use), 67 TFLOP/s float32 outside the tensor
# cores (Precision.HIGHEST), 3.35 TB/s HBM3, at the card's maximum power
# of 700 W.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"tf32": 495.0, "f32": 67.0, "hbm": 3350.0,
                              "power_w": 700.0},
}
# nvidia-smi's name and power limit of the card the run is on
CARD = None


def peaks():
    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device {kind!r}; add a "
                       f"row with its source to bench_kernels.PEAKS")
    return PEAKS[kind]


def warm_time(fn, *args):
    """Warm per-call seconds of jit(fn)(*args)."""
    return measure(jax.jit(fn), *args).warm_s


def emit(kernel, value, unit, **extra):
    dev = jax.devices()[0]
    watts = power_limit_w(CARD)
    print(json.dumps({"kernel": kernel, "value": value, "unit": unit,
                      "device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": jax.device_count()},
                      "power_limit_w": watts,
                      "below_peaks_power": watts < peaks()["power_w"],
                      **extra}), flush=True)


def bench_matmul_calibration(n=4096):
    rng = np.random.default_rng(9)
    M = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32) / np.sqrt(n))
    dt = warm_time(lambda a: a @ a, M)
    tflops = 2 * n ** 3 / dt / 1e12
    emit("matmul_calibration", tflops, "TFLOP/s", n=n,
         roofline_share_tf32=tflops / peaks()["tf32"], bound="tf32")


def bench_small_cholesky(batch=262144, n=6):
    from libdogleg_tpu.ops.smallchol import small_cholesky
    rng = np.random.default_rng(0)
    A = rng.normal(size=(batch, n, n)).astype(np.float32)
    spd = jnp.asarray(A @ np.swapaxes(A, -1, -2)
                      + 4 * np.eye(n, dtype=np.float32))
    dt = warm_time(lambda a: small_cholesky(a)[0], spd)
    gbytes = batch * (2 * n * n * 4) / 1e9   # read A, write L
    emit("small_cholesky_batched", batch / dt / 1e6, "Mfact/s",
         n=n, batch=batch, achieved_gbps=gbytes / dt,
         roofline_share=gbytes / dt / peaks()["hbm"], bound="HBM")


def bench_jtj_formation(batch=32768, m=100, n=6):
    rng = np.random.default_rng(1)
    J = jnp.asarray(rng.normal(size=(batch, m, n)).astype(np.float32))
    dt = warm_time(
        lambda a: jnp.einsum('bmi,bmj->bij', a, a,
                             preferred_element_type=jnp.float32), J)
    gbytes = batch * (m * n + n * n) * 4 / 1e9
    tflops = batch * 2 * m * n * n / dt / 1e12
    emit("jtj_formation_batched", gbytes / dt, "GB/s",
         batch=batch, m=m, n=n,
         roofline_share=gbytes / dt / peaks()["hbm"], bound="HBM",
         achieved_tflops=tflops)


def bench_dense_cholesky(n=2048, batch=8):
    """XLA's lax.linalg lowering (cuSOLVER) vs the recursive GEMM-dominant
    blocked form (ops/largechol.py), whose products run at
    Precision.HIGHEST: its bound is the float32 rate outside the tensor
    cores."""
    from libdogleg_tpu.ops.largechol import large_cholesky
    rng = np.random.default_rng(2)
    A = rng.normal(size=(batch, n, n)).astype(np.float32)
    spd = jnp.asarray(A @ np.swapaxes(A, -1, -2)
                      + n * np.eye(n, dtype=np.float32))
    dt_xla = warm_time(jnp.linalg.cholesky, spd)
    dt = warm_time(lambda a: large_cholesky(a)[0], spd)
    flops = batch * (n ** 3 / 3)
    tflops = flops / dt / 1e12
    emit("dense_cholesky", tflops, "TFLOP/s", n=n, batch=batch,
         algo="largechol blocked right-looking",
         roofline_share_f32=tflops / peaks()["f32"], bound="f32",
         xla_lax_linalg_tflops=flops / dt_xla / 1e12,
         speedup_vs_xla=dt_xla / dt)


def bench_blocked_cholesky(batch=512, n=64):
    """The mid-size batched factorization (ops/blockchol.py, config 8's hot
    kernel). Memory-bound like small_cholesky (n=64 f32 is 16 KB per
    matrix); also reports the lax.linalg baseline."""
    from libdogleg_tpu.ops.blockchol import blocked_cholesky
    rng = np.random.default_rng(4)
    A = rng.normal(size=(batch, n, n)).astype(np.float32)
    spd = jnp.asarray(A @ np.swapaxes(A, -1, -2)
                      + n * np.eye(n, dtype=np.float32))
    dt = warm_time(lambda a: blocked_cholesky(a)[0], spd)
    dt_xla = warm_time(jnp.linalg.cholesky, spd)
    gbytes = batch * (2 * n * n * 4) / 1e9
    emit("blocked_cholesky_batched", batch / dt / 1e3, "kfact/s",
         n=n, batch=batch, achieved_gbps=gbytes / dt,
         roofline_share=gbytes / dt / peaks()["hbm"], bound="HBM",
         xla_lax_linalg_ms=dt_xla * 1e3, speedup_vs_xla=dt_xla / dt)


def bench_sparse_cholesky(nb=256, b=64, band=3):
    from libdogleg_tpu import sparse_cholesky as sc
    from libdogleg_tpu.native.loader import native_available
    # Warm the one-time on-demand g++ build of the native symbolic
    # library outside the timed region.
    native_available()
    rows = np.array([i for j in range(nb)
                     for i in range(j, min(nb, j + band))])
    cols = np.array([j for j in range(nb)
                     for i in range(j, min(nb, j + band))])
    t0 = time.perf_counter()
    sym = sc.analyze(rows, cols, nb, b)
    analyze_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    blocks = rng.normal(size=(rows.shape[0], b, b)).astype(np.float32) * 0.1
    diag = rows == cols
    blocks[diag] = (blocks[diag] @ np.swapaxes(blocks[diag], -1, -2)
                    + np.eye(b, dtype=np.float32) * (3 + band))
    blocks = jnp.asarray(blocks)
    dt = warm_time(lambda v: sc.factorize(sym, v, jnp.asarray(0.0))[0],
                      blocks)
    n_upd = sym.sched.upd_tgt.shape[0]
    n_sol = sym.sched.sol_tgt.shape[0]
    flops = (2 * n_upd + n_sol + nb / 3) * b ** 3
    emit("block_sparse_cholesky", 1.0 / dt, "fact/s",
         nb=nb, b=b, nnzb=int(rows.shape[0]), levels=sym.sched.nlevels,
         analyze_ms=analyze_s * 1e3,
         achieved_tflops=flops / dt / 1e12,
         bound="elimination-tree critical path")


if __name__ == "__main__":
    if jax.devices()[0].platform != "gpu":
        print("bench_kernels.py needs a GPU", file=sys.stderr)
        sys.exit(2)
    CARD = card_line()
    print(f"card: {CARD}", flush=True)
    bench_matmul_calibration()
    bench_small_cholesky()
    bench_jtj_formation()
    bench_dense_cholesky()
    bench_blocked_cholesky()
    bench_sparse_cholesky()
