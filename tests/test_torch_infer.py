"""clonealign_torch.infer against clonealign_tpu.infer.

The loop-parity tests start both packages from the JAX package's initial
parameters (through ``clonealign_torch.convert``) and feed the port the
exact draws of JAX's key schedule (infer.py: split(key, 3) for the warm
start and initial ELBO, split(key, 3) per iteration, then 20 keys from
fold_in(key, 7) for the final ELBO), in float64.

Tolerances: the ELBO trace at rtol 1e-6 and gamma at atol 1e-5, the bars
tests/test_tf_reference_loop.py holds the JAX loop to against TF1 (two
autodiff systems differ by ~1 ulp per gradient and Adam's sqrt(v)
normalization amplifies it over the iterations); labels identical.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clonealign_tpu import infer as jinfer
from clonealign_tpu.assign import clone_assignment
from clonealign_tpu.models import multinomial as jmm
from clonealign_torch import convert
from clonealign_torch import infer as tinfer
from clonealign_torch.models import multinomial as tmm

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
EXAMPLE_SCE = REPO / "data" / "example_sce.npz"


class JaxKeySchedule:
    """Noise source that replays jinfer.run_inference's draws."""

    def __init__(self, k_fit, n_final=20):
        self.kk, self.k_warm, self.k_init = jax.random.split(k_fit, 3)
        self.k_eval = None
        self.finals = None
        self.n_final = n_final

    def normal(self, what, shape, dtype, device):
        if what == "warm":
            k = self.k_warm
        elif what == "init_eval":
            k = self.k_init
        elif what == "train":
            self.kk, k, self.k_eval = jax.random.split(self.kk, 3)
        elif what == "eval":
            k = self.k_eval
        elif what == "final":
            if self.finals is None:
                self.finals = list(jax.random.split(jax.random.fold_in(self.kk, 7), self.n_final))
            k = self.finals.pop(0)
        else:
            raise AssertionError(f"unexpected draw {what!r}")
        return torch.tensor(np.asarray(jax.random.normal(k, tuple(shape), jnp.float64)),
                            dtype=dtype, device=device)


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12), ("float32", 1e-6)])
def test_tf1_adam_matches_jax(dtype, rtol):
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (4, 1)]
    params = [rng.normal(size=s).astype(dtype) for s in shapes]
    opt = jinfer.tf1_adam(0.1)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    tp = [torch.tensor(p) for p in params]
    topt = tinfer.TF1Adam(tp, 0.1)
    for _ in range(6):
        grads = [rng.normal(size=s).astype(dtype) for s in shapes]
        updates, state = opt.update([jnp.asarray(g) for g in grads], state)
        jp = optax.apply_updates(jp, updates)
        topt.step(tp, [torch.tensor(g) for g in grads])
        for a, b in zip(tp, jp):
            assert a.dtype == (torch.float64 if dtype == "float64" else torch.float32)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=rtol)


def _example_start(seed=11):
    z = np.load(EXAMPLE_SCE)
    Y = z["counts"].astype(np.float64)
    L = z["copy_number"].astype(np.float64)
    k_init, k_fit = jax.random.split(jax.random.PRNGKey(seed))
    params0 = jmm.init_params(Y, L, k_init, K=1, dtype=jnp.float64)
    return Y, L, params0, k_fit


@pytest.mark.parametrize("max_iter,rel_tol,elbo_eval", [
    (50, 0.0, "fresh"),   # rel_tol=0: exactly max_iter iterations on both sides
    (20, 0.0, "reuse"),
    # At run_inference's default rel_tol (1e-5) the window test does not fire
    # on example_sce within 400 iterations; 1e-3 fires at iteration 43.
    (100, 1e-3, "fresh"),
])
def test_loop_matches_jax(max_iter, rel_tol, elbo_eval):
    Y, L, params0, k_fit = _example_start()
    jdata = jmm.prepare_data(Y, L, dtype=jnp.float64)
    config = jmm.ModelConfig(K=1, P=0, mc_samples=1, likelihood_impl="xla")
    res = jinfer.run_inference(params0, jdata, k_fit, config, max_iter=max_iter,
                               rel_tol=rel_tol, elbo_eval=elbo_eval)

    got = tinfer.run_inference(
        convert.params_from_numpy(params0, "cpu", torch.float64),
        tmm.prepare_data(Y, L, device="cpu", dtype=torch.float64),
        JaxKeySchedule(k_fit), tmm.ModelConfig(K=1, mc_samples=1),
        max_iter=max_iter, rel_tol=rel_tol, elbo_eval=elbo_eval,
    )
    n = int(res.n_iters)
    assert got.n_iters == n
    if rel_tol > 0:
        assert n < max_iter  # the early stop fired
    np.testing.assert_allclose(got.elbo_trace[: n + 1], np.asarray(res.elbo_trace)[: n + 1],
                               rtol=1e-6)
    assert np.isnan(got.elbo_trace[n + 1:]).all()
    gamma_j = np.asarray(jax.nn.softmax(res.params.gamma_logits, axis=1))
    gamma_t = torch.softmax(got.params.gamma_logits, dim=1).numpy()
    np.testing.assert_allclose(gamma_t, gamma_j, atol=1e-5)
    names = ["A", "B", "C"]
    assert clone_assignment(gamma_t, names) == clone_assignment(gamma_j, names)
    np.testing.assert_allclose(got.final_elbo, float(res.final_elbo), rtol=1e-6)
    np.testing.assert_allclose(got.sd_final_elbo, float(res.sd_final_elbo), rtol=1e-4)


def test_rejects_unknown_elbo_eval():
    Y, L, params0, _ = _example_start()
    with pytest.raises(ValueError, match="elbo_eval"):
        tinfer.run_inference(
            convert.params_from_numpy(params0, "cpu", torch.float64),
            tmm.prepare_data(Y, L, device="cpu", dtype=torch.float64),
            None, tmm.ModelConfig(), elbo_eval="sometimes",
        )
