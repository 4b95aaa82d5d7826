"""The backward Riccati sweep op (ops/riccati_sweep.py): the Triton kernel
in interpret mode against the plain recursion, the padding and the choice
of kernel in the vmap rule, and the compiled kernel on the GPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cafempc.ops import riccati_sweep as rs


def _operands(rng, B, N, xs, us, dtype=np.float64, indefinite=(),
              a_near_identity=False):
    """Random sweep operands with a leading batch axis; scenarios listed in
    `indefinite` get a negative-definite luu so their PSD test fails.
    a_near_identity: A = I + small noise, like discretized dynamics, which
    keeps the value Hessians well conditioned for float32 checks."""
    def mk(shape, s=0.4):
        return rng.normal(size=shape) * s

    def spd(n, lead, s=0.45):
        M = rng.normal(size=lead + (n, n)) * s
        return np.einsum("...ij,...kj->...ik", M, M) + 0.5 * np.eye(n)

    luu = spd(us, (B, N))
    for b in indefinite:
        luu[b] = -10.0 * luu[b]
    A = (np.eye(xs) + mk((B, N, xs, xs), 0.03) if a_near_identity
         else mk((B, N, xs, xs)))
    ops = [A, mk((B, N, xs, us)), mk((B, N, xs)),
           mk((B, N, us)), spd(xs, (B, N)), luu, mk((B, N, us, xs), 0.05),
           mk((B, xs)), spd(xs, (B,)), mk((B, N + 1, xs), 0.01)]
    w = np.zeros(N, np.int32)
    w[[2, N - 3]] = 1
    reg = np.linspace(0.01, 0.05, B)
    return ([jnp.asarray(o, dtype) for o in ops], jnp.asarray(w),
            jnp.asarray(reg, dtype))


def _vrecursion(ops, w, reg):
    return jax.vmap(rs._recursion, in_axes=(0,) * 10 + (None, 0))(
        *ops, w, reg)


@pytest.mark.parametrize("xs,us", [(6, 3), (24, 24), (36, 12)])
def test_kernel_matches_recursion(rng, xs, us):
    """Padding to (16|32|64) widths + Gauss-Jordan elimination reproduce
    the Cholesky recursion, per-scenario reg included."""
    ops, w, reg = _operands(rng, 3, 7, xs, us)
    ref = _vrecursion(ops, w, reg)
    out = rs.kernel_sweep(*ops, w, reg, interpret=True)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-10 * max(np.abs(b).max(), 1.0)


def test_kernel_psd_flags(rng):
    """A scenario whose Quu is indefinite is flagged, like the recursion's
    Cholesky test; the others are untouched by it."""
    ops, w, reg = _operands(rng, 3, 6, 6, 3, indefinite=(1,))
    ref = _vrecursion(ops, w, reg)
    out = rs.kernel_sweep(*ops, w, reg, interpret=True)
    np.testing.assert_array_equal(np.asarray(out[7]), [1.0, 0.0, 1.0])
    np.testing.assert_array_equal(np.asarray(out[7]), np.asarray(ref[7]))
    for a, b in zip(out[:7], ref[:7]):
        np.testing.assert_allclose(np.asarray(a)[::2], np.asarray(b)[::2],
                                   rtol=1e-9, atol=1e-11)


def test_pow2_widths():
    assert [rs._pow2(n) for n in (1, 12, 16, 17, 24, 36, 64)] == \
        [16, 16, 16, 32, 32, 64, 64]


def test_sweep_op_rules_on_cpu(rng):
    """Un-batched: the recursion.  Under vmap off the GPU: the vmapped
    recursion, with unbatched operands broadcast."""
    ops, w, reg = _operands(rng, 2, 5, 6, 3)
    ref = _vrecursion(ops, w, reg)
    one = rs.sweep_op(*[o[0] for o in ops], w, reg[0])
    for a, b in zip(one, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b)[0],
                                   rtol=1e-12)
    # terminal cost shared by the batch (unbatched phix/phixx)
    in_axes = (0,) * 7 + (None, None, 0, None, 0)
    shared = list(ops)
    shared[7], shared[8] = ops[7][0], ops[8][0]
    out = jax.jit(jax.vmap(rs.sweep_op, in_axes=in_axes))(*shared, w, reg)
    exp = _vrecursion(
        ops[:7] + [jnp.broadcast_to(ops[7][0], ops[7].shape),
                   jnp.broadcast_to(ops[8][0], ops[8].shape), ops[9]],
        w, reg)
    for a, b in zip(out, exp):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)


def test_sweep_op_rejects_batched_flags(rng):
    ops, w, reg = _operands(rng, 2, 5, 6, 3)
    w_b = jnp.broadcast_to(w, (2,) + w.shape)
    with pytest.raises(ValueError, match="must not be batched"):
        jax.vmap(rs.sweep_op)(*ops, w_b, reg)


@pytest.mark.parametrize("platform,kernel", [("cuda", True), ("cpu", False)])
def test_kernel_chosen_by_platform(rng, platform, kernel):
    """The batched rule lowers to the Triton kernel for CUDA and only
    there; lowering for CUDA works without a card."""
    ops, w, reg = _operands(rng, 4, 5, 24, 24, np.float32)
    f = jax.jit(jax.vmap(rs.sweep_op, in_axes=(0,) * 10 + (None, 0)))
    text = f.trace(*ops, w, reg).lower(
        lowering_platforms=(platform,)).as_text()
    assert ("__gpu$xla.gpu.triton" in text) == kernel


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,xs,us", [(4, 12, 24, 24), (3, 9, 36, 12),
                                       (2, 7, 6, 3)])
def test_compiled_kernel_matches_recursion(rng, B, N, xs, us):
    """The kernel as compiled for the card, float32, against the float64
    recursion on the same inputs."""
    ops, w, reg = _operands(rng, B, N, xs, us, np.float32, indefinite=(1,),
                            a_near_identity=True)
    out = jax.jit(rs.kernel_sweep)(*ops, w, reg)
    ref = _vrecursion([o.astype(jnp.float64) for o in ops], w,
                      reg.astype(jnp.float64))
    np.testing.assert_array_equal(np.asarray(out[7]), np.asarray(ref[7]))
    keep = np.asarray(ref[7]) > 0.5
    for a, b in zip(out[:7], ref[:7]):
        a, b = np.asarray(a, np.float64)[keep], np.asarray(b)[keep]
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1.0)
