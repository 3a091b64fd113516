"""The port's exact-extent fold conv: the geometry, the period bound the
kernels are given, and ``dense_fold_conv`` against the JAX package's.

At ``K = 1`` and ``Lp = total`` the masked tap conv is the zero-padded
Conv2d over the ``[cycles, p]`` grid, so the plain forward, adjoint and
weight gradient equal ``torch.nn.functional.conv2d`` and its autograd
gradients there within 1e-5 (float32). That needs the period bound of the
geometry, ``p_max``: ``Lp - L`` is ``(-L) % p`` at the exact extent, 0 at
p = 7 and L = 28, and gave too few zero rows. ``dense_fold_conv`` holds to
the JAX package's ``dense_fold_conv`` and ``jax.grad`` within 1e-5 (dW
2e-5) in float32. In bf16 both sides round their inputs, the conv's output
and dW to bf16 and sum in float32 in different orders, so a value near a
rounding boundary can land one bf16 step (2**-8 relative) apart: 1e-2, and
2e-2 of the largest value for the gradients.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from flow_timesnet_tpu.ops import fold as jfold  # noqa: E402
from flow_timesnet_tpu_torch.ops import cuda_fold, fold  # noqa: E402

L = 28
PERIODS = (7, 14, 27)
KERNELS = ((3, 3), (5, 5), (7, 7))


def _inputs(seed, p, kh, kw, cin=4, cout=6, B=3):
    rng = np.random.default_rng(seed)
    total = L + (-L) % p
    h = rng.standard_normal((1, B, total, cin)).astype(np.float32)
    kernel = (0.3 * rng.standard_normal((kh, kw, cin, cout))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    ct = rng.standard_normal((1, B, total, cout)).astype(np.float32)
    return h, kernel, bias, ct


def _grid(x, geom):
    """[1, B, total, C] -> the NCHW [B, C, cycles, p] grid."""

    cycles, p = int(geom.cycles[0]), int(geom.periods[0])
    return x[0].reshape(x.shape[1], cycles, p, x.shape[-1]).permute(0, 3, 1, 2)


def _fold(y, total):
    """NCHW [B, C, cycles, p] -> [1, B, total, C]."""

    return y.permute(0, 2, 3, 1).reshape(1, y.shape[0], total, y.shape[1])


@pytest.mark.parametrize("p", PERIODS)
def test_dense_geometry_is_the_exact_grid(p):
    geom = fold.make_dense_geometry(p, L)
    total = L + (-L) % p
    assert (geom.Lp, geom.L, geom.p_max, geom.dense) == (total, L, p, True)
    assert geom.periods.tolist() == [p] and geom.total.tolist() == [total]
    assert geom.cycles.tolist() == [total // p]
    t = np.arange(total)
    np.testing.assert_array_equal(geom.col.numpy(), (t % p)[None])
    np.testing.assert_array_equal(geom.row.numpy(), (t // p)[None])
    assert all(v.dtype == torch.int32 for v in (geom.periods, geom.total, geom.cycles,
                                                geom.col, geom.row))
    assert fold.make_dense_geometry(p, L) is geom  # built once per (p, L, device)
    padded = fold.make_geometry(torch.tensor([p], dtype=torch.int32), L, L - 1)
    assert (padded.p_max, padded.dense) == (L - 1, False)


@pytest.mark.parametrize("kh,kw", KERNELS)
@pytest.mark.parametrize("p", PERIODS)
def test_plain_fold_conv_at_the_exact_extent_is_conv2d(p, kh, kw):
    """The plain forward, dh and dW over the exact grid against conv2d and
    its autograd gradients (float32, 1e-5)."""

    h, kernel, bias, ct = (torch.from_numpy(a) for a in _inputs(p + kh, p, kh, kw))
    geom = fold.make_dense_geometry(p, L)
    total = geom.Lp
    w_oihw = kernel.permute(3, 2, 0, 1)
    hg = _grid(h, geom).requires_grad_()
    wg = w_oihw.clone().requires_grad_()
    ref = torch.nn.functional.conv2d(hg, wg, bias, padding=(kh // 2, kw // 2))
    ref.backward(_grid(ct, geom))

    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fold.tap_conv(h, geom, kernel, bias, kh, kw),
                               _fold(ref.detach(), total), **tol)
    torch.testing.assert_close(fold.tap_conv_dh(ct, geom, kernel, kh, kw),
                               _fold(hg.grad, total), **tol)
    torch.testing.assert_close(fold.tap_weight_grad(h, geom, ct, kh, kw),
                               wg.grad.permute(2, 3, 1, 0), **tol)


def _record_p_max(monkeypatch):
    """Plan mirrors that record the ``p_max`` a wrapper gives them, then stop
    the launch; the CUDA-tensor check is waived (this is the CPU)."""

    seen = []

    class Stop(Exception):
        pass

    def recorder(name):
        def plan(*args):
            seen.append((name, args[-1]))
            raise Stop

        return plan

    def stop(*args):
        raise Stop

    monkeypatch.setattr(cuda_fold, "_check", lambda *a: None)
    for name in ("fold_mma_plan", "dw_mma_plan", "fwd_f32_plan", "dh_f32_plan"):
        monkeypatch.setattr(cuda_fold, name, recorder(name))
    for name in ("dw_f32_plan", "_fwd_fns", "_bwd_fns", "_mma_fns"):  # no bound, or a build
        monkeypatch.setattr(cuda_fold, name, stop)
    return seen, Stop


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("p", PERIODS)
def test_every_kernel_wrapper_gets_the_geometry_period_bound(p, dtype, monkeypatch):
    seen, Stop = _record_p_max(monkeypatch)
    geom = fold.make_dense_geometry(p, L)
    h = torch.zeros((1, 2, geom.Lp, 32), dtype=dtype)
    w, b = torch.zeros(3, 3, 32, 32), torch.zeros(32)
    for launch in (lambda: cuda_fold.tap_conv_cuda(h, geom, w, b, 3, 3),
                   lambda: cuda_fold.tap_conv_dh_cuda(h, geom, w, 3, 3),
                   lambda: cuda_fold.tap_conv_dw_cuda(h, geom, h, 3, 3)):
        try:
            launch()
        except Stop:
            pass
    mma = dtype == torch.bfloat16
    names = (["fold_mma_plan", "fold_mma_plan", "dw_mma_plan"] if mma
             else ["fwd_f32_plan", "dh_f32_plan"])  # the float32 dW plan takes no bound
    assert seen == [(n, p) for n in names]
    assert cuda_fold._check_geometry("x", geom, h) == p != geom.Lp - geom.L
    padded = fold.make_geometry(torch.tensor([p], dtype=torch.int32), L, L - 1)
    assert cuda_fold._check_geometry("x", padded, torch.zeros(1, 2, padded.Lp, 32)) == L - 1


@pytest.mark.parametrize("batch", [192, 256])
@pytest.mark.parametrize("kh,kw", KERNELS)
@pytest.mark.parametrize("p", (7, 27))
def test_every_plan_takes_the_exact_extent_with_its_period(p, kh, kw, batch):
    """Each plan mirror at the flagship's exact-extent shapes (32 channels):
    its zero rows are the period's, ``(kh // 2) * p + kw // 2``; the old
    bound ``Lp - L`` is 0 at p = 7, which every plan refuses, and one row
    too few at p = 27."""

    geom = fold.make_dense_geometry(p, L)
    Lp, pad = geom.Lp, (kh // 2) * p + kw // 2
    shape = (1, batch, Lp, 32, 32, kh, kw)
    plans = (lambda b: cuda_fold.fold_mma_plan(1, *shape, b),
             lambda b: cuda_fold.fold_mma_plan(-1, *shape, b),
             lambda b: cuda_fold.dw_mma_plan(*shape, b),
             lambda b: cuda_fold.fwd_f32_plan(*shape, b),
             lambda b: cuda_fold.dh_f32_plan(*shape, b))
    for plan in plans:
        assert plan(geom.p_max).pad == pad
        if Lp - L == 0:
            with pytest.raises(RuntimeError, match=r"p_max must lie in \[1, Lp\]"):
                plan(Lp - L)
        else:
            assert plan(Lp - L).pad < pad
    assert cuda_fold.dw_f32_plan(*shape).chunks >= 1


def _jax_dense(h, kernel, bias, ct, p, kh, kw, dtype):
    geom = jfold.make_dense_geometry(p, L)

    def loss(h_, k_, b_):
        out = jfold.dense_fold_conv(h_.astype(dtype), geom, k_, b_, kh, kw)
        return jnp.sum(out * jnp.asarray(ct)), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(h), jnp.asarray(kernel), jnp.asarray(bias))
    return [np.asarray(a, np.float32) for a in (out, *grads)]


def _port_dense(h, kernel, bias, ct, p, kh, kw, dtype):
    geom = fold.make_dense_geometry(p, L)
    args = [torch.from_numpy(a).requires_grad_() for a in (h, kernel, bias)]
    out = cuda_fold.dense_fold_conv(args[0].to(dtype), geom, args[1], args[2], kh, kw)
    out.backward(torch.from_numpy(ct))
    return [a.detach().float().numpy() for a in (out, *(x.grad for x in args))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kh,kw", ((3, 3), (7, 7)))
@pytest.mark.parametrize("p", PERIODS)
def test_dense_fold_conv_matches_jax(p, kh, kw, dtype):
    h, kernel, bias, ct = _inputs(10 + p, p, kh, kw)
    want = _jax_dense(h, kernel, bias, ct, p, kh, kw, jnp.dtype(dtype))
    got = _port_dense(h, kernel, bias, ct, p, kh, kw, getattr(torch, dtype))
    for counter in (cuda_fold.launches, cuda_fold.launches_dh, cuda_fold.launches_dw):
        assert not counter  # the CPU runs the plain versions, never a kernel
    names = ("out", "dh", "dW", "db")
    if dtype == "float32":
        tols = (1e-5, 1e-5, 2e-5, 1e-5)
        for name, g, w, tol in zip(names, got, want, tols):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)
        return
    np.testing.assert_allclose(got[0], want[0], rtol=1e-2, atol=1e-2, err_msg="out")
    for name, g, w in zip(names[1:], got[1:], want[1:]):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=2e-2, atol=2e-2 * scale, err_msg=name)
    # the dense form's rounding: dW and the conv's sum are bf16 values
    dw = torch.from_numpy(got[2])
    assert torch.equal(dw, dw.bfloat16().float())
    conv = torch.from_numpy(got[0]) - torch.from_numpy(bias)
    assert float((conv - conv.bfloat16().float()).abs().max()) <= 1e-6


def test_dense_fold_conv_float32_is_the_tap_form():
    """In float32 the dense form's roundings are the identity: the same
    numbers as :func:`cuda_fold.tap_conv` on the same geometry, gradients too."""

    h, kernel, bias, ct = _inputs(3, 7, 5, 5)
    geom = fold.make_dense_geometry(7, L)
    outs = []
    for conv in (cuda_fold.dense_fold_conv, cuda_fold.tap_conv):
        args = [torch.from_numpy(a).requires_grad_() for a in (h, kernel, bias)]
        out = conv(args[0], geom, args[1], args[2], 5, 5)
        out.backward(torch.from_numpy(ct))
        outs.append([out.detach(), *(a.grad for a in args)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="make_dense_geometry"):
        cuda_fold.dense_fold_conv(torch.from_numpy(h), fold.make_geometry(
            torch.tensor([7], dtype=torch.int32), L, L - 1), torch.from_numpy(kernel),
            torch.from_numpy(bias), 5, 5)
