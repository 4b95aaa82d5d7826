"""Backward Riccati sweep of HS-DDP, with a GPU kernel for scenario batches.

`sweep_op` is a `jax.custom_batching.custom_vmap` operation:

* called un-batched (single-robot MPC, the float64 references), it is the
  plain sequential recursion, a reverse `lax.scan`;
* under `vmap` on a CUDA device it runs `kernel_sweep`: one Triton program
  per scenario walks the whole horizon with its (G, H) value carry kept in
  registers, so a sweep is one kernel launch and the carry never goes back
  to device memory between knots (the design of batched GPU DDP solvers,
  GATO in PAPERS.md);
* under `vmap` elsewhere it is the vmapped recursion.

Semantics per step k, walked in reverse (SinglePhase.cpp:323-391 +
MultiPhaseDDP.cpp:174-213):

  dynamics step (w=0):   Q-expansion from (G', H') with Gn = G' + H' d,
                         PSD check of Quu - 1e-9 I, gains K/dU, value
                         update, dV accumulation;
  transform step (w=1):  G = phix + A^T Gn, H = phixx + A^T H' A (A holds
                         the reset-map partial Px; padding steps have A=0).

A step is EITHER a dynamics step (reads lx/lxx) OR a transform step (reads
phix/phixx), so the caller passes one merged cost stream
(lx := where(w, phix, lx), lxx := where(w, phixx, lxx)); the transform
branch is then the Q-expansion base before regularization.
"""
import functools

import jax
import jax.numpy as jnp
from jax import custom_batching, lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

_HI = lax.Precision.HIGHEST   # IEEE float32 products, never TF32


def _recursion(A, B, lx, lu, lxx, luu, lux, phix_term, phixx_term, defect,
               w, reg):
    """The sequential sweep for ONE scenario.  Shapes: A [N,xs,xs],
    B [N,xs,us], lx [N,xs] and lxx [N,xs,xs] (merged streams), lu [N,us],
    luu [N,us,us], lux [N,us,xs], phix_term [xs] / phixx_term [xs,xs]
    terminal cost, defect [N+1,xs], w [N] int32, reg scalar.
    Returns (G [N,xs], H, K, dU, Qu, Quu, Qux, ok [], dv [2])."""
    xs = A.shape[1]
    us = B.shape[2]
    I_u = jnp.eye(us, dtype=A.dtype)
    I_x = jnp.eye(xs, dtype=A.dtype)

    def step(carry, inp):
        G1, H1, ok, dv1, dv2 = carry
        (Ak, Bk, lxk, luk, lxxk, luuk, luxk, dft, wk) = inp
        Gn = G1 + H1 @ dft
        Qx = lxk + Ak.T @ Gn
        Qxx_base = lxxk + Ak.T @ H1 @ Ak
        Qu = luk + Bk.T @ Gn
        Qxx = Qxx_base + reg * I_x
        Qxx = 0.5 * (Qxx + Qxx.T)
        Quu = luuk + Bk.T @ H1 @ Bk + reg * I_u
        Qux = luxk + Bk.T @ H1 @ Ak
        L = jnp.linalg.cholesky(Quu - 1e-9 * I_u)
        ok_k = jnp.all(jnp.isfinite(L))
        L_safe = jnp.where(ok_k, L, I_u)
        Quu_inv = jax.scipy.linalg.cho_solve((L_safe, True), I_u)
        dU = -Quu_inv @ Qu
        K = -Quu_inv @ Qux
        G_dyn = Qx + Qux.T @ dU
        H_dyn = Qxx + Qux.T @ K
        H_dyn = 0.5 * (H_dyn + H_dyn.T)
        wf = (wk > 0)
        G0 = jnp.where(wf, Qx, G_dyn)
        H0 = jnp.where(wf, Qxx_base, H_dyn)
        dv_k = jnp.where(wf, 0.0, Qu @ dU)
        out = (G0, H0, jnp.where(wf, jnp.zeros_like(K), K),
               jnp.where(wf, jnp.zeros_like(dU), dU),
               jnp.where(wf, jnp.zeros_like(Qu), Qu),
               jnp.where(wf, I_u, Quu),
               jnp.where(wf, jnp.zeros_like(Qux), Qux))
        return (G0, H0, ok & (ok_k | wf), dv1 + dv_k, dv2 - dv_k), out

    zero = jnp.zeros((), A.dtype)
    inp = (A, B, lx, lu, lxx, luu, lux, defect[1:], w)
    (_, _, ok, dv1, dv2), (G, H, K, dU, Qu, Quu, Qux) = lax.scan(
        step, (phix_term, phixx_term, jnp.bool_(True), zero, zero), inp,
        reverse=True)
    return G, H, K, dU, Qu, Quu, Qux, ok.astype(A.dtype), jnp.stack(
        [dv1, dv2])


# ---------------------------------------------------------------- kernel --

def _pow2(n):
    """Smallest power of two >= n, and >= 16 (Triton's least dot width)."""
    return max(16, 1 << (int(n) - 1).bit_length())


def _sweep_kernel(w_ref, reg_ref, A_ref, B_ref, lx_ref, lu_ref, lxx_ref,
                  luu_ref, lux_ref, d_ref, phix_ref, phixx_ref,
                  G_ref, H_ref, K_ref, dU_ref, Qu_ref, Quu_ref, Qux_ref,
                  stats_ref):
    """One program = one scenario.  Refs hold that scenario's padded
    operands (X, U: state and control widths padded to powers of two);
    d_ref[k] is the defect at knot k+1.  stats = (ok, dv1, dv2, 0)."""
    n_steps, X = lx_ref.shape
    U = lu_ref.shape[1]
    dt = lx_ref.dtype
    reg = reg_ref[0]
    rx = lax.broadcasted_iota(jnp.int32, (X, X), 0)
    cx = lax.broadcasted_iota(jnp.int32, (X, X), 1)
    ru = lax.broadcasted_iota(jnp.int32, (U, U), 0)
    cu = lax.broadcasted_iota(jnp.int32, (U, U), 1)
    rux = lax.broadcasted_iota(jnp.int32, (U, X), 0)
    iu = lax.broadcasted_iota(jnp.int32, (U,), 0)
    I_x = (rx == cx).astype(dt)
    I_u = (ru == cu).astype(dt)

    def mm(a, b):       # a @ b
        return jnp.dot(a, b, precision=_HI)

    def mtm(a, b):      # a^T @ b
        return lax.dot_general(a, b, (((0,), (0,)), ((), ())),
                               precision=_HI)

    def mv(m, v):       # m @ v
        return jnp.sum(m * v[None, :], axis=1)

    def mtv(m, v):      # m^T @ v
        return jnp.sum(m * v[:, None], axis=0)

    def eliminate(j, c):
        """Gauss-Jordan step j on M (symmetric, no pivoting) carrying the
        right-hand sides y [U] and Y [U,X].  Its pivots are the diagonal of
        the LDL^T factorization, so all of them are positive exactly when
        M is positive definite: the Cholesky PSD test of the recursion."""
        M, y, Y, ok = c
        row = jnp.sum(jnp.where(ru == j, M, 0.0), axis=0)
        col = jnp.sum(jnp.where(cu == j, M, 0.0), axis=1)
        piv = jnp.sum(jnp.where(iu == j, row, 0.0))
        good = piv > 0.0
        inv = 1.0 / jnp.where(good, piv, 1.0)
        f = jnp.where(iu == j, 0.0, col * inv)
        yj = jnp.sum(jnp.where(iu == j, y, 0.0))
        Yj = jnp.sum(jnp.where(rux == j, Y, 0.0), axis=0)
        M = jnp.where(ru == j, row[None, :] * inv, M - f[:, None] * row[None, :])
        y = jnp.where(iu == j, yj * inv, y - f * yj)
        Y = jnp.where(rux == j, Yj[None, :] * inv,
                      Y - f[:, None] * Yj[None, :])
        return M, y, Y, ok & good

    def step(i, carry):
        G1, H1, ok, dv1, dv2 = carry
        k = n_steps - 1 - i
        A = A_ref[k]
        Bm = B_ref[k]
        wf = (w_ref[k] > 0).astype(dt)
        Gn = G1 + mv(H1, d_ref[k])
        HA = mm(H1, A)
        HB = mm(H1, Bm)
        Qx = lx_ref[k] + mtv(A, Gn)
        Qxx_base = lxx_ref[k] + mtm(A, HA)
        Qu = lu_ref[k] + mtv(Bm, Gn)
        Quu = luu_ref[k] + mtm(Bm, HB) + reg * I_u
        Qux = lux_ref[k] + mtm(Bm, HA)
        Qxx = Qxx_base + reg * I_x
        Qxx = 0.5 * (Qxx + Qxx.T)

        _, y, Y, ok_k = lax.fori_loop(
            0, U, eliminate, (Quu - 1e-9 * I_u, Qu, Qux, jnp.bool_(True)))
        dU = -y
        K = -Y
        G_dyn = Qx + mtv(Qux, dU)
        H_dyn = Qxx + mtm(Qux, K)
        H_dyn = 0.5 * (H_dyn + H_dyn.T)

        G0 = wf * Qx + (1.0 - wf) * G_dyn
        H0 = wf * Qxx_base + (1.0 - wf) * H_dyn
        dv_k = (1.0 - wf) * jnp.sum(Qu * dU)
        zf = 1.0 - wf
        G_ref[k] = G0
        H_ref[k] = H0
        K_ref[k] = K * zf
        dU_ref[k] = dU * zf
        Qu_ref[k] = Qu * zf
        Quu_ref[k] = Quu * zf + wf * I_u
        Qux_ref[k] = Qux * zf
        ok = ok & (ok_k | (wf > 0.0))
        return G0, H0, ok, dv1 + dv_k, dv2 - dv_k

    zero = jnp.zeros((), dt)
    _, _, ok, dv1, dv2 = lax.fori_loop(
        0, n_steps, step,
        (phix_ref[...], phixx_ref[...], jnp.bool_(True), zero, zero))
    i4 = lax.broadcasted_iota(jnp.int32, (4,), 0)
    stats_ref[...] = jnp.where(
        i4 == 0, ok.astype(dt),
        jnp.where(i4 == 1, dv1, jnp.where(i4 == 2, dv2, 0.0)))


def _pallas_sweep(w, reg, A, B, lx, lu, lxx, luu, lux, d, phix, phixx,
                  interpret):
    Bsz, N, X = lx.shape
    U = lu.shape[2]
    dt = A.dtype

    def per_scn(*block):
        return pl.BlockSpec((None,) + block, lambda b: (b,) + (0,) * len(block))

    in_specs = [pl.BlockSpec((N,), lambda b: (0,)), per_scn(1),
                per_scn(N, X, X), per_scn(N, X, U), per_scn(N, X),
                per_scn(N, U), per_scn(N, X, X), per_scn(N, U, U),
                per_scn(N, U, X), per_scn(N, X), per_scn(X),
                per_scn(X, X)]
    out_shapes = [(N, X), (N, X, X), (N, U, X), (N, U), (N, U), (N, U, U),
                  (N, U, X), (4,)]
    return pl.pallas_call(
        _sweep_kernel,
        out_shape=[jax.ShapeDtypeStruct((Bsz,) + s, dt) for s in out_shapes],
        grid=(Bsz,),
        in_specs=in_specs,
        out_specs=[per_scn(*s) for s in out_shapes],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4 if X <= 32 else 8,
                                           num_stages=1),
        interpret=interpret,
        name="riccati_sweep",
    )(w, reg, A, B, lx, lu, lxx, luu, lux, d, phix, phixx)


def kernel_sweep(A, B, lx, lu, lxx, luu, lux, phix_term, phixx_term,
                 defect, w, reg, *, interpret=False):
    """`_recursion` for a batch of scenarios through the Triton kernel.

    Every operand but `w` [N] carries a leading batch axis; reg is [Bsz].
    State and control widths are zero-padded to powers of two; the padded
    diagonal of luu is the identity, which keeps the padded block of Quu
    positive definite and decoupled, so the PSD flag and the real outputs
    are those of the unpadded recursion."""
    Bsz, N, xs = lx.shape
    us = lu.shape[2]
    X, U = _pow2(xs), _pow2(us)

    def pad(a, *widths):
        cfg = [(0, 0)] * (a.ndim - len(widths)) + [
            (0, t - s) for s, t in zip(a.shape[a.ndim - len(widths):],
                                       widths)]
        return jnp.pad(a, cfg)

    eye_pad = jnp.diag((jnp.arange(U) >= us).astype(luu.dtype))
    out = _pallas_sweep(
        jnp.asarray(w, jnp.int32), reg.reshape(Bsz, 1),
        pad(A, X, X), pad(B, X, U), pad(lx, X), pad(lu, U), pad(lxx, X, X),
        pad(luu, U, U) + eye_pad, pad(lux, U, X), pad(defect[:, 1:], X),
        pad(phix_term, X), pad(phixx_term, X, X), interpret)
    G, H, K, dU, Qu, Quu, Qux, stats = out
    return (G[..., :xs], H[..., :xs, :xs], K[..., :us, :xs], dU[..., :us],
            Qu[..., :us], Quu[..., :us, :us], Qux[..., :us, :xs],
            stats[:, 0], stats[:, 1:3])


# ----------------------------------------------------------- dispatch op --

@custom_batching.custom_vmap
def sweep_op(A, B, lx, lu, lxx, luu, lux, phix_term, phixx_term, defect, w,
             reg):
    """Backward sweep for ONE scenario (see `_recursion` for shapes)."""
    return _recursion(A, B, lx, lu, lxx, luu, lux, phix_term, phixx_term,
                      defect, w, reg)


@sweep_op.def_vmap
def _sweep_op_vmap(axis_size, in_batched, *args):
    if in_batched[10]:
        raise ValueError("sweep_op: the transform flags w come from the "
                         "shared plan and must not be batched")
    args, in_batched = list(args), list(in_batched)
    w = jnp.asarray(args.pop(10))
    del in_batched[10]
    args = [a if b else jnp.broadcast_to(a, (axis_size,) + jnp.shape(a))
            for a, b in zip(args, in_batched)]
    vrec = jax.vmap(lambda *a: _recursion(*a[:10], w, a[10]))
    out = lax.platform_dependent(
        *args,
        cuda=lambda *a: kernel_sweep(*a[:10], w, a[10]),
        default=vrec)
    return tuple(out), (True,) * 9
