"""clonealign_torch's fused-likelihood op against the JAX package's.

The same float32 numpy inputs go through the JAX Pallas kernel (interpret
mode on the CPU, as tests/test_fused_likelihood.py runs it), JAX's plain
``reference_likelihood_terms`` and the port's plain versions, which are what
the port's autograd function runs on CPU tensors. The CUDA kernels
themselves are checked against the plain versions on the card
(``cuda`` marker; skipped without a GPU). Y also goes in each narrow storage
type the kernels load (bfloat16, int16, int8): on the CPU against the same
counts in float32 and against the Pallas op given Y in that type, and on
the card against the float32-Y kernels, bit for bit.

Tolerance: rtol 2e-5 / atol 1e-4 for values and rtol 3e-5 / atol 1e-4 for
the VJP, the bars tests/test_fused_likelihood.py holds the Pallas kernel to:
float32 sums over up to 1,000 genes taken in different orders.

jax is imported by the ``jax_ops`` fixture, not at the top: the GPU machine
has no jax, and the ``cuda`` tests run there with
``python -m pytest --noconftest -m cuda tests/test_torch_fused_likelihood.py``.
"""

import numpy as np
import pytest
import torch

from clonealign_torch.ops import fused_likelihood as tfl

torch.set_num_threads(2)

SHAPES = [(70, 90, 4, 2, 2), (130, 257, 3, 1, 1), (37, 41, 2, 1, 1)]
# (N, G, C, K, S) covering every S*C bound the kernels are built for (the
# forward's and the dpsi kernel's 1, 2 and 4 n-tiles of 8 columns, with
# S*C = 1, 8, 9, 16, 17, 20, 32; the gene-major kernel's B of (1 + Kf) S*C
# columns in 1, 2, 3 and 4 n-tiles a pass, in one pass or, for 40 to 160
# columns, in 2 to 10 passes), one row and a ragged 16-row
# tile (N = 1, 17), cells in several 1,024-cell chunks (N = 2100), one gene,
# gene counts ragged against the 32- and 128-gene tiles with and without
# 16-byte rows (G = 1000, 700, 260 / 41, 129, 130, 515), and Kf = 0..4
CUDA_SHAPES = SHAPES + [(333, 1000, 10, 1, 1), (257, 700, 16, 4, 1), (100, 129, 10, 1, 2),
                        (5, 3000, 1, 0, 1), (1, 200, 9, 1, 1), (17, 333, 17, 3, 1),
                        (40, 1, 8, 2, 4), (50, 515, 16, 4, 2), (64, 515, 8, 4, 4),
                        (33, 130, 32, 4, 1), (45, 260, 8, 1, 1), (2100, 130, 5, 1, 2),
                        (60, 300, 16, 1, 1), (200, 512, 10, 1, 1)]
# Y storage types the kernels load; the test counts (Poisson, mean 3) are
# exact in each
STORAGES = [torch.float32, torch.bfloat16, torch.int16, torch.int8]
VALUE_TOL = dict(rtol=2e-5, atol=1e-4)
VJP_TOL = dict(rtol=3e-5, atol=1e-4)


def _inputs(N, G, C, K, S, seed):
    """Y, psi, W, log_mu, muL as float32 numpy arrays (the recipe of
    tests/test_fused_likelihood.py)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    Y = rng.poisson(3.0, (N, G)).astype(f32)
    psi = rng.normal(0, 1, (N, K)).astype(f32)
    W = rng.normal(0, 0.3, (G, K)).astype(f32)
    mu = rng.lognormal(0, 0.5, (S, G)).astype(f32)
    L = rng.integers(1, 5, (G, C)).astype(f32)
    muL = (mu[:, None, :] * L.T[None]).transpose(2, 0, 1).reshape(G, S * C)
    return Y, psi, W, np.log(mu), np.ascontiguousarray(muL)


def _cotangents(N, S, SC, seed):
    rng = np.random.default_rng(seed + 1000)
    return (rng.normal(0, 1, N).astype(np.float32),
            rng.normal(0, 1, (N, S)).astype(np.float32),
            rng.normal(0, 1, (N, SC)).astype(np.float32))


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def jax_ops():
    """(jax, jax.numpy, the JAX package's fused-likelihood module)."""
    jax = pytest.importorskip("jax")
    jfl = pytest.importorskip("clonealign_tpu.ops.fused_likelihood")
    return jax, jax.numpy, jfl


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_pallas_and_jax_reference(shape, jax_ops):
    jax, jnp, jfl = jax_ops
    N, G, C, K, S = shape
    x = _inputs(N, G, C, K, S, seed=N)
    pallas = [np.asarray(t) for t in jfl.fused_likelihood_terms(*map(jnp.asarray, x))]
    jref = [np.asarray(t) for t in jfl.reference_likelihood_terms(*map(jnp.asarray, x))]
    ours = [t.numpy() for t in tfl.reference_likelihood_terms(*_torch(x))]
    for name, o, p, r in zip(("A1", "A2", "Z"), ours, pallas, jref):
        assert o.dtype == np.float32
        np.testing.assert_allclose(o, p, err_msg=name, **VALUE_TOL)
        np.testing.assert_allclose(o, r, err_msg=name, **VALUE_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_vjp_matches_pallas(shape, jax_ops):
    """The explicit backward formulas and the autograd function's CPU
    gradients against jax.vjp of the Pallas op."""
    jax, jnp, jfl = jax_ops
    N, G, C, K, S = shape
    x = _inputs(N, G, C, K, S, seed=N + 1)
    cot = _cotangents(N, S, S * C, seed=N)
    _, vjp = jax.vjp(jfl.fused_likelihood_terms, *map(jnp.asarray, x))
    want = [np.asarray(g) for g in vjp(tuple(map(jnp.asarray, cot)))[1:]]

    Y, psi, W, log_mu, muL = _torch(x)
    dA1, dA2, dZ = _torch(cot)
    explicit = tfl.reference_likelihood_vjp(Y, psi, W, muL, dA1, dA2, dZ)

    leaves = [t.clone().requires_grad_(True) for t in (psi, W, log_mu, muL)]
    outs = tfl.fused_likelihood_terms(Y, *leaves)
    auto = torch.autograd.grad(outs, leaves, grad_outputs=(dA1, dA2, dZ))

    for name, w, e, a in zip(("psi", "W", "log_mu", "muL"), want, explicit, auto):
        np.testing.assert_allclose(e.numpy(), w, err_msg=name, **VJP_TOL)
        np.testing.assert_allclose(a.numpy(), w, err_msg=name, **VJP_TOL)


def test_skipping_a2_matches_zero_a2_cotangent(jax_ops):
    """log_mu=None (the ELBO step's form) returns no A2, and the gradients
    equal the full op's with a zero A2 cotangent."""
    jax, jnp, jfl = jax_ops
    N, G, C, K, S = SHAPES[2]
    x = _inputs(N, G, C, K, S, seed=5)
    cot = _cotangents(N, S, S * C, seed=5)
    _, vjp = jax.vjp(jfl.fused_likelihood_terms, *map(jnp.asarray, x))
    want = vjp((jnp.asarray(cot[0]), jnp.zeros((N, S), jnp.float32), jnp.asarray(cot[2])))

    Y, psi, W, _log_mu, muL = _torch(x)
    leaves = [t.clone().requires_grad_(True) for t in (psi, W, muL)]
    A1, A2, Z = tfl.fused_likelihood_terms(Y, leaves[0], leaves[1], None, leaves[2])
    assert A2 is None
    got = torch.autograd.grad((A1, Z), leaves, grad_outputs=_torch((cot[0], cot[2])))
    for name, g, w in zip(("psi", "W", "muL"), got, (want[1], want[2], want[4])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **VJP_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_dpsi_matches_pallas(shape, jax_ops):
    """The Y-free dpsi (from Y W and the forward's tables) against the psi
    cotangent of jax.vjp of the Pallas op."""
    jax, jnp, jfl = jax_ops
    N, G, C, K, S = shape
    x = _inputs(N, G, C, K, S, seed=N + 2)
    cot = _cotangents(N, S, S * C, seed=N + 2)
    _, vjp = jax.vjp(jfl.fused_likelihood_terms, *map(jnp.asarray, x))
    want = np.asarray(vjp(tuple(map(jnp.asarray, cot)))[1])

    Y, psi, W, _log_mu, muL = _torch(x)
    dA1, _dA2, dZ = _torch(cot)
    got = tfl.reference_dpsi(Y @ W, psi, W, muL, dA1, dZ)
    np.testing.assert_allclose(got.numpy(), want, **VJP_TOL)


@pytest.mark.parametrize("shape", SHAPES + [(17, 33, 8, 4, 2), (5, 9, 3, 0, 1)])
def test_reference_dpsi_identity_float64(shape):
    """dA1 (Y W) + sum_j dZ_j (rfe W_k) muL_j equals dlog_rfe W exactly: in
    float64 the two orders of summation agree to rounding."""
    N, G, C, K, S = shape
    x = [a.astype(np.float64) for a in _inputs(N, G, C, K, S, seed=N + 3)]
    cot = [a.astype(np.float64) for a in _cotangents(N, S, S * C, seed=N + 3)]
    Y, psi, W, _log_mu, muL = _torch(x)
    dA1, dA2, dZ = _torch(cot)
    got = tfl.reference_dpsi(Y @ W, psi, W, muL, dA1, dZ)
    want = tfl.reference_likelihood_vjp(Y, psi, W, muL, dA1, dA2, dZ)[0]
    assert got.dtype == torch.float64 and got.shape == (N, K)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_gene_matches_pallas(shape, jax_ops):
    """The re-associated gene-major formulas (dW, dlog mu, d(muL) without
    dZ muL^T) against the W, log mu and muL cotangents of jax.vjp of the
    Pallas op."""
    jax, jnp, jfl = jax_ops
    N, G, C, K, S = shape
    x = _inputs(N, G, C, K, S, seed=N + 4)
    cot = _cotangents(N, S, S * C, seed=N + 4)
    _, vjp = jax.vjp(jfl.fused_likelihood_terms, *map(jnp.asarray, x))
    want = [np.asarray(g) for g in vjp(tuple(map(jnp.asarray, cot)))[2:]]

    Y, psi, W, _log_mu, muL = _torch(x)
    dA1, dA2, dZ = _torch(cot)
    got = tfl.reference_gene(Y, psi, W, muL, dA1, dA2, dZ)
    for name, g, w in zip(("W", "log_mu", "muL"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **VJP_TOL)


@pytest.mark.parametrize("shape", SHAPES + [(17, 33, 8, 4, 2), (5, 9, 3, 0, 1)])
def test_reference_gene_identity_float64(shape):
    """Y^T (dA1 psi) + sum_j muL_j (rfe^T (dZ_j psi)) equals dlog_rfe^T psi
    exactly: in float64 the two orders of summation agree to rounding, and
    dlog mu and d(muL) are the same formulas."""
    N, G, C, K, S = shape
    x = [a.astype(np.float64) for a in _inputs(N, G, C, K, S, seed=N + 5)]
    cot = [a.astype(np.float64) for a in _cotangents(N, S, S * C, seed=N + 5)]
    Y, psi, W, _log_mu, muL = _torch(x)
    dA1, dA2, dZ = _torch(cot)
    got = tfl.reference_gene(Y, psi, W, muL, dA1, dA2, dZ)
    want = tfl.reference_likelihood_vjp(Y, psi, W, muL, dA1, dA2, dZ)[1:]
    assert got[0].dtype == torch.float64 and got[0].shape == (G, K)
    for name, g, w in zip(("W", "log_mu", "muL"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-12, err_msg=name)
    assert tfl.reference_gene(Y, psi, W, muL, dA1, None, dZ)[1] is None


@pytest.mark.parametrize("storage", [torch.bfloat16, torch.int16, torch.int8])
@pytest.mark.parametrize("shape", SHAPES)
def test_narrow_y_on_cpu_matches_float32_y_and_pallas(shape, storage, jax_ops):
    """The op with Y stored narrow, on CPU tensors: its values and gradients
    equal those with the same counts in float32 exactly (the plain versions
    convert Y first), and hold against the Pallas op (interpret mode) given
    Y in the same storage type."""
    jax, jnp, jfl = jax_ops
    N, G, C, K, S = shape
    x = _inputs(N, G, C, K, S, seed=N + 6)
    cot = _cotangents(N, S, S * C, seed=N + 6)
    Yf, psi, W, log_mu, muL = _torch(x)
    Y = Yf.to(storage)
    assert torch.equal(Y.float(), Yf)  # Poisson(3) counts are exact in every storage type
    got, want = [], []
    for y, out in ((Y, got), (Yf, want)):
        leaves = [t.clone().requires_grad_(True) for t in (psi, W, log_mu, muL)]
        terms = tfl.fused_likelihood_terms(y, *leaves)
        out += [*terms, *torch.autograd.grad(terms, leaves, grad_outputs=_torch(cot))]
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i
    jY = jnp.asarray(Y.float().numpy()).astype(jnp.dtype(str(storage).removeprefix("torch.")))
    jx = (jY, *map(jnp.asarray, x[1:]))
    pallas, vjp = jax.vjp(jfl.fused_likelihood_terms, *jx)
    pallas_grads = vjp(tuple(map(jnp.asarray, cot)))[1:]
    for name, g, p in zip(("A1", "A2", "Z"), got[:3], pallas):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(p), err_msg=name, **VALUE_TOL)
    for name, g, p in zip(("psi", "W", "log_mu", "muL"), got[3:], pallas_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), err_msg=name, **VJP_TOL)


@pytest.mark.parametrize("mode", ["psi_grad", "no_grad", "psi_frozen"])
def test_autograd_cpu_path_needs_no_yw(mode):
    """On CPU tensors the autograd function runs the whole plain VJP, which
    needs no Y W: it keeps none, and its gradients are the plain VJP's for
    whichever leaves need one."""
    N, G, C, K, S = SHAPES[0]
    Y, psi, W, log_mu, muL = _torch(_inputs(N, G, C, K, S, seed=7))
    dA1, dA2, dZ = _torch(_cotangents(N, S, S * C, seed=7))
    leaves = [t.clone().requires_grad_(mode != "psi_frozen" or i > 0)
              for i, t in enumerate((psi, W, log_mu, muL))]
    if mode == "no_grad":
        with torch.no_grad():
            outs = tfl.fused_likelihood_terms(Y, *leaves)
        assert all(o.grad_fn is None for o in outs)
    else:
        outs = tfl.fused_likelihood_terms(Y, *leaves)
        assert outs[0].grad_fn.saved_tensors[-1] is None
    for name, o, w in zip(("A1", "A2", "Z"), outs,
                          tfl.reference_likelihood_terms(Y, psi, W, log_mu, muL)):
        np.testing.assert_array_equal(o.detach().numpy(), w.numpy(), err_msg=name)
    if mode == "no_grad":
        return
    need = [i for i, t in enumerate(leaves) if t.requires_grad]
    got = torch.autograd.grad(outs, [leaves[i] for i in need], grad_outputs=(dA1, dA2, dZ))
    want = tfl.reference_likelihood_vjp(Y, psi, W, muL, dA1, dA2, dZ)
    for i, g in zip(need, got):
        np.testing.assert_allclose(g.numpy(), want[i].numpy(), err_msg=str(i), **VJP_TOL)


@pytest.mark.cuda
def test_cuda_kernels_refuse_other_y_dtypes():
    """A Y dtype the kernels do not load raises; it is not converted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    Y, psi, W, log_mu, muL = [t.cuda() for t in _torch(_inputs(8, 16, 2, 1, 1, seed=0))]
    dA1, dA2, dZ = [t.cuda() for t in _torch(_cotangents(8, 1, 2, seed=0))]
    for dtype in (torch.float64, torch.float16, torch.int32, torch.uint8):
        with pytest.raises(ValueError, match="Y must be one of"):
            tfl.kernel_forward(Y.to(dtype), psi, W, log_mu, muL)
        with pytest.raises(ValueError, match="Y must be one of"):
            tfl.kernel_gene(Y.to(dtype), psi, W, muL, dA1, dA2, dZ)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise: there is no
    fallback to the plain version inside them."""
    Y, psi, W, log_mu, muL = _torch(_inputs(8, 16, 2, 1, 1, seed=0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfl.kernel_forward(Y, psi, W, log_mu, muL)
    dA1, dA2, dZ = _torch(_cotangents(8, 1, 2, seed=0))
    YW = Y @ W
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfl.kernel_backward(Y, psi, W, muL, dA1, dA2, dZ, YW)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfl.kernel_dpsi(psi, W, muL, dA1, dZ, YW)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfl.kernel_gene(Y, psi, W, muL, dA1, dA2, dZ)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_kernels_match_plain(shape, storage):
    """Forward (A2 on and off) and backward kernels against the plain
    versions on the card, with Y in each storage type the kernels load. The
    backward takes Y W from the forward kernel, as the fit does; each
    wrapper counts its launches (the dpsi kernel has nothing to launch when
    Kf = 0). The forward and dpsi are held against the float32 plain
    versions; dW, dlog mu and d(muL) against the float64 plain version of
    the same float32 inputs, because the gene-major kernel sums dW's rfe
    term in another association (:func:`reference_gene`) and at
    (257, 700, 16, 4, 1) the float32 plain dW is itself farther than the
    tolerance from the float64 one. The counts are exact in every storage
    type, so a narrow Y gives the float32 Y's results bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    N, G, C, K, S = shape
    x = [t.cuda() for t in _torch(_inputs(N, G, C, K, S, seed=N))]
    dA1, dA2, dZ = [t.cuda() for t in _torch(_cotangents(N, S, S * C, seed=N))]
    Yf, psi, W, log_mu, muL = x
    Y = Yf.to(storage)
    before = (tfl.fwd_launches, tfl.dpsi_launches, tfl.gene_launches)
    for lm, da2 in ((log_mu, dA2), (None, None)):
        *got, YW = tfl.kernel_forward(Y, psi, W, lm, muL)
        for g, f in zip((*got, YW), tfl.kernel_forward(Yf, psi, W, lm, muL)):
            assert (g is None and f is None) or torch.equal(g, f)
        assert torch.equal(tfl.kernel_gene(Y, psi, W, muL, dA1, da2, dZ)[0],
                           tfl.kernel_gene(Yf, psi, W, muL, dA1, da2, dZ)[0])
        want = tfl.reference_likelihood_terms(Y, psi, W, lm, muL)
        for g, w in zip(got, want):
            if w is not None:
                np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **VALUE_TOL)
        np.testing.assert_allclose(YW.cpu().numpy(), (Yf @ W).cpu().numpy(), **VALUE_TOL)
        got = tfl.kernel_backward(Y, psi, W, muL, dA1, da2, dZ, YW)
        want = tfl.reference_likelihood_vjp(Y, psi, W, muL, dA1, da2, dZ)
        exact = tfl.reference_likelihood_vjp(
            *[None if t is None else t.double() for t in (Y, psi, W, muL, dA1, da2, dZ)])
        for g, w in zip(got, (want[0], *exact[1:])):
            if w is not None:
                np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **VJP_TOL)
    launched = (4, 2 if K else 0, 6)
    assert (tfl.fwd_launches, tfl.dpsi_launches, tfl.gene_launches) == tuple(
        b + n for b, n in zip(before, launched))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(333, 1000, 10, 1, 1), (64, 515, 8, 4, 4)])
def test_cuda_gene_kernel_is_deterministic(shape):
    """The gene-major kernel adds its partial sums in a fixed order, with no
    atomics: two calls on the same inputs give bitwise-equal results."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    N, G, C, K, S = shape
    Y, psi, W, _log_mu, muL = [t.cuda() for t in _torch(_inputs(N, G, C, K, S, seed=N))]
    dA1, dA2, dZ = [t.cuda() for t in _torch(_cotangents(N, S, S * C, seed=N))]
    first = tfl.kernel_gene(Y, psi, W, muL, dA1, dA2, dZ)
    second = tfl.kernel_gene(Y, psi, W, muL, dA1, dA2, dZ)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
