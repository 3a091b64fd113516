"""The two routes of the 1x1 conv (``ops/fold.py::pointwise_conv``) on the CPU.

- The tensor-core route runs on a card alone (``aten::addmm.dtype`` and
  ``aten::mm.dtype`` have no CPU kernel). On meta tensors its forward and
  backward give the shapes and dtypes the model needs: the output in the
  type asked for, ``dh`` in bf16, ``dW`` and ``db`` in float32, and the
  route counter counts each direction once.
- A CPU tensor takes the float32 route, whatever its dtype: the plain
  expression, cast to the output type, bit for bit, counted once each way.

Its values on the card: ``tests/test_torch_cuda.py``.
"""

import pytest
import torch

from flow_timesnet_tpu_torch.ops import fold


@pytest.fixture(autouse=True)
def cleared_runs():
    fold.clear_pointwise_runs()
    yield
    fold.clear_pointwise_runs()


def _runs(tc_fwd, tc_bwd, f32_fwd, f32_bwd):
    return {"tensor_core": {"fwd": tc_fwd, "bwd": tc_bwd},
            "float32": {"fwd": f32_fwd, "bwd": f32_bwd}}


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(27, 12), (3, 3, 3, 12), "expanded"])
def test_the_tensor_core_route_on_meta_tensors(shape, out_dtype):
    x = torch.empty(3, 9, 12, device="meta", dtype=torch.bfloat16, requires_grad=True)
    kernel = torch.empty(12, 20, device="meta", requires_grad=True)
    bias = torch.empty(20, device="meta", requires_grad=True)
    # a candidate axis of stride 0, as a fold's input
    h = x[None].expand(2, 3, 9, 12) if shape == "expanded" else x.reshape(shape)
    out = fold._TensorCorePointwise.apply(h, kernel, bias, out_dtype)
    assert out.shape == (*h.shape[:-1], 20) and out.dtype == out_dtype
    out.backward(torch.empty(out.shape, device="meta", dtype=out_dtype))
    assert (x.grad.shape, x.grad.dtype) == (x.shape, torch.bfloat16)
    assert (kernel.grad.shape, kernel.grad.dtype) == (kernel.shape, torch.float32)
    assert (bias.grad.shape, bias.grad.dtype) == (bias.shape, torch.float32)
    # a float32 cotangent is not rounded to bf16: its backward is the float32 one
    cores = out_dtype == torch.bfloat16
    assert fold.pointwise_runs() == _runs(1, int(cores), 0, int(not cores))


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_a_cpu_tensor_takes_the_float32_route(dtype, grad):
    gen = torch.Generator().manual_seed(0)
    h0 = torch.randn(2, 5, 8, generator=gen).to(dtype)
    k0, b0 = torch.randn(8, 6, generator=gen), torch.randn(6, generator=gen)

    def run(plain):
        h, k, b = (t.clone().requires_grad_(grad) for t in (h0, k0, b0))
        if plain:
            out = (h.float() @ k.to(dtype).float() + b.float()).to(dtype)
        else:
            out = fold.pointwise_conv(h, k, b, dtype)
        if grad:
            out.backward(torch.ones_like(out))
        return [out.detach()] + ([h.grad, k.grad, b.grad] if grad else [])

    got = run(False)
    assert fold.pointwise_runs() == _runs(0, 0, 1, int(grad))
    want = run(True)
    assert all(a.dtype == w.dtype and torch.equal(a, w) for a, w in zip(got, want))
    assert got[0].dtype == dtype
