"""K6a / K6b plain versions (``eventad_tpu_torch/ops/gather_window.py``)
against the JAX package on the same numpy inputs: the XLA formulation and
the Pallas kernels in interpret mode.  On the CPU the port's dispatchers run
the plain versions; the CUDA kernels are held against them on the card by
``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventad_tpu.ops.gather_window import (_gather_window_diff,
                                           gather_window_rows as jax_gather,
                                           scatter_window_rows as jax_scatter)
from eventad_tpu_torch.ops import gather_window as gw


def _case(rng, n, k, c, lookback, tail=0):
    """Window-local neighbour table honouring the event-graph contract;
    masked slots hold -1 or an out-of-window index, and the last ``tail``
    rows are an under-filled (fully masked) tail."""
    src = rng.randn(n, c).astype(np.float32)
    nbr = np.zeros((n, k), np.int32)
    mask = rng.rand(n, k) > 0.3
    for i in range(n):
        nbr[i] = rng.randint(max(0, i - lookback), i + 1, k)
    mask[0] = False
    if tail:
        mask[n - tail:] = False
    junk = np.where(rng.rand(n, k) > 0.5, -1, n + 7).astype(np.int32)
    return src, np.where(mask, nbr, junk), mask


# (n, k, c, lookback, under-filled tail): n not a multiple of the Pallas
# block, lookback == n, and a fully masked tail
CASES = [(300, 15, 19, 128, 0), (333, 15, 16, 333, 0), (520, 4, 7, 260, 0),
         (300, 8, 10, 128, 90)]


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n,k,c,lb,tail", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_equals_xla_formulation(rng, n, k, c, lb, tail, dtype):
    src, nbr, mask = _case(rng, n, k, c, lb, tail)
    jsrc = jnp.asarray(src).astype(dtype)
    safe = jnp.asarray(np.where(mask, nbr, 0))
    want = jnp.where(jnp.asarray(mask)[..., None], jsrc[safe], 0)
    tsrc, tnbr, tmask = _torch(src, nbr, mask)
    tsrc = tsrc.to(getattr(torch, dtype))
    for fn in (lambda: gw.gather_window_rows_plain(tsrc, tnbr, tmask),
               lambda: gw.gather_rows_auto(tsrc, tnbr, tmask, lookback=lb)):
        got = fn()
        assert got.dtype == tsrc.dtype and got.shape == (n, k, c)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    assert (got[~tmask] == 0).all()


@pytest.mark.parametrize("n,k,c,lb,tail", CASES)
@pytest.mark.parametrize("parts,rtol", [(3, 0.0), (2, 2.0 ** -16)])
def test_gather_equals_pallas_interpret(rng, n, k, c, lb, tail, parts, rtol):
    src, nbr, mask = _case(rng, n, k, c, lb, tail)
    want = np.asarray(jax_gather(jnp.asarray(src), jnp.asarray(nbr),
                                 jnp.asarray(mask), lookback=lb, parts=parts,
                                 interpret=True))
    got = gw.gather_window_rows(*_torch(src, nbr, mask), lookback=lb).numpy()
    if parts == 3:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(want, got, rtol=rtol, atol=0)


@pytest.mark.parametrize("n,k,c,lb,tail", CASES)
def test_scatter_matches_jax(rng, n, k, c, lb, tail):
    _, nbr, mask = _case(rng, n, k, c, lb, tail)
    g = rng.randn(n, k, c).astype(np.float32)
    got = gw.scatter_window_rows(*_torch(g, nbr, mask), n, lookback=lb)
    assert got.dtype == torch.float32 and got.shape == (n, c)
    safe = np.where(mask, nbr, 0)
    gm = jnp.where(jnp.asarray(mask)[..., None], jnp.asarray(g), 0.0)
    xla = jnp.zeros((n, c), jnp.float32).at[jnp.asarray(safe)].add(gm)
    pallas = jax_scatter(jnp.asarray(g), jnp.asarray(safe), jnp.asarray(mask),
                         n, parts=3, interpret=True)
    scale = np.abs(np.asarray(xla)).max()
    for want in (xla, pallas):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6 * scale


def test_scatter_bf16_cotangent(rng):
    """A bf16 cotangent sums in f32 and returns bf16
    (gather_window.py:361-367)."""
    n, k, c, lb = 300, 8, 16, 128
    _, nbr, mask = _case(rng, n, k, c, lb)
    g = rng.randn(n, k, c).astype(np.float32)
    tg, tnbr, tmask = _torch(g, nbr, mask)
    tg = tg.to(torch.bfloat16)
    got = gw.scatter_window_rows(tg, tnbr, tmask, n, lookback=lb)
    assert got.dtype == torch.bfloat16
    want = gw.scatter_window_rows_plain(tg.float(), tnbr, tmask, n)
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,k,c,lb,tail", CASES[:2])
def test_gather_gradient_matches_jax_vjp(rng, n, k, c, lb, tail):
    """d sum(gather * r) / d src through ``GatherWindowRows`` (on the CPU
    its forward and backward are the plain versions) against ``jax.grad``
    through the custom VJP with the Pallas kernels in interpret mode, and
    against autograd through the plain gather."""
    src, nbr, mask = _case(rng, n, k, c, lb, tail)
    r = rng.randn(n, k, c).astype(np.float32)
    safe = jnp.asarray(np.where(mask, nbr, 0))
    want = np.asarray(jax.grad(lambda s: jnp.sum(_gather_window_diff(
        s, safe, jnp.asarray(mask), lb, True, 3) * jnp.asarray(r)))(
            jnp.asarray(src)))
    tsrc, tnbr, tmask, tr = _torch(src, nbr, mask, r)
    grads = []
    for fn in (lambda s: gw.gather_rows_auto(s, tnbr, tmask, lookback=lb),
               lambda s: gw.gather_window_rows_plain(s, tnbr, tmask)):
        s = tsrc.clone().requires_grad_(True)
        (fn(s) * tr).sum().backward()
        grads.append(s.grad.numpy())
    scale = np.abs(want).max()
    for got in grads:
        assert got.shape == src.shape
        assert np.abs(got - want).max() <= 1e-6 * scale


def test_cuda_wrappers_refuse_cpu_tensors(rng):
    """The kernel wrappers never give way to the plain version."""
    src, nbr, mask = _case(rng, 40, 4, 5, 16)
    args = _torch(src, nbr, mask)
    with pytest.raises(ValueError):
        gw.gather_window_rows_cuda(*args, lookback=16)
    with pytest.raises(ValueError):
        gw.scatter_window_rows_cuda(torch.zeros(40, 4, 5), args[1], args[2],
                                    40, lookback=16)
    assert gw.gather_window_rows_cuda.launches == 0
    assert gw.scatter_window_rows_cuda.launches == 0
