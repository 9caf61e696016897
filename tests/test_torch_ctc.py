"""The port's CTC loss (kaldi_aslp_tpu_torch/ops/ctc.py, with the plain
versions of the alpha/beta kernels on the CPU) against the JAX package:
the Pallas recursions ``_alpha_kernel`` / ``_beta_kernel`` in interpret
mode at the shapes of tests/test_ctc_pallas.py, the JAX ``ctc_loss``
custom VJP and ``ctc_batch_loss``, and, in this test only,
``torch.nn.functional.ctc_loss``.  Inputs come from numpy seeds.

Tolerance rtol=atol=1e-4 on alphas, betas and the nll (float32 on both
sides, exp and log may differ in the last bit); 1e-4 absolute on the
logits gradient (a difference of probabilities)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.models.losses import (
    ctc_batch_loss as jax_ctc_batch_loss,
    ctc_loss_spike_mask as jax_spike_mask,
)
from kaldi_aslp_tpu.ops.ctc import (
    _transition_mask as jax_transition_mask,
    ctc_alpha_beta as jax_ctc_alpha_beta,
)
from kaldi_aslp_tpu.ops.ctc_pallas import ctc_alpha_beta_pallas
from kaldi_aslp_tpu_torch.models.losses import (
    ctc_batch_loss,
    ctc_loss_spike_mask,
)
from kaldi_aslp_tpu_torch.ops import ctc_recursions as recursions
from kaldi_aslp_tpu_torch.ops.ctc import (
    NEG_INF,
    ctc_alpha_beta,
    ctc_loss,
    expand_labels,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _case(S, T, V, U, in_lens, lab_lens, seed):
    rs = np.random.RandomState(seed)
    logits = rs.randn(S, T, V).astype(np.float32)
    labels = rs.randint(1, V, (S, U)).astype(np.int32)
    return (logits, labels, np.asarray(in_lens, np.int32),
            np.asarray(lab_lens, np.int32))


CASES = {
    # tests/test_ctc_pallas.py's shape
    "pallas": (4, 18, 9, 5, [18, 14, 11, 9], [5, 4, 2, 1]),
    # tests/test_ctc.py's torch cross-check shape
    "torch": (4, 20, 10, 6, [20, 17, 12, 9], [6, 4, 3, 1]),
}


def _reachable(a, b, name):
    mask = (a > NEG_INF / 2) | (b > NEG_INF / 2)
    both = (a > NEG_INF / 2) & (b > NEG_INF / 2)
    assert (both == mask).all(), f"{name}: reachability differs"
    np.testing.assert_allclose(a[both], b[both], err_msg=name, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_alpha_beta_match_jax_pallas(case):
    logits, labels, in_lens, lab_lens = _case(*CASES[case], seed=1)
    log_probs = jax.nn.log_softmax(jnp.asarray(logits), -1)
    nll_j, _, _, lp_t, exp_labels, valid_u = jax_ctc_alpha_beta(
        log_probs, jnp.asarray(labels), jnp.asarray(in_lens),
        jnp.asarray(lab_lens))
    skip_ok = jax_transition_mask(exp_labels, 0) * valid_u
    a_j, b_j = ctc_alpha_beta_pallas(lp_t, skip_ok, jnp.asarray(in_lens),
                                     2 * jnp.asarray(lab_lens) + 1,
                                     interpret=True)
    nll, alphas, betas, lp_t_p, _, _ = ctc_alpha_beta(
        torch.log_softmax(torch.from_numpy(logits), -1),
        torch.from_numpy(labels), torch.from_numpy(in_lens),
        torch.from_numpy(lab_lens))
    np.testing.assert_allclose(lp_t_p.numpy(), np.asarray(lp_t), **TOL)
    a_j, b_j = np.asarray(a_j), np.asarray(b_j)
    for s in range(len(in_lens)):
        n = int(in_lens[s])
        _reachable(alphas.numpy()[:n, s], a_j[:n, s], f"alpha s={s}")
        _reachable(betas.numpy()[:n, s], b_j[:n, s], f"beta s={s}")
    np.testing.assert_allclose(nll.numpy(), np.asarray(nll_j), **TOL)


@pytest.mark.parametrize("Up", [1, 2, 3, 33])
def test_plain_recursions_match_jax_pallas_at_any_width(Up):
    """The plain versions of the CUDA kernel at widths no wider than the
    skip (U' = 1, 2), an even U' and a partial last group of 32, on direct
    inputs: ragged expanded lengths down to 1, input lengths from 1 to T."""
    S, T = 4, 9
    rs = np.random.RandomState(Up)
    exp_lens = rs.randint(1, Up + 1, S).astype(np.int32)
    exp_lens[0], exp_lens[-1] = Up, 1
    in_lens = rs.randint(1, T + 1, S).astype(np.int32)
    in_lens[0] = T
    valid = np.arange(Up)[None, :] < exp_lens[:, None]
    lp = np.where(valid[None], rs.randn(T, S, Up) - 2.0,
                  NEG_INF).astype(np.float32)
    skip = ((rs.rand(S, Up) > 0.3) & valid).astype(np.float32)
    a_j, b_j = ctc_alpha_beta_pallas(*(jnp.asarray(x) for x in
                                       (lp, skip, in_lens, exp_lens)),
                                     interpret=True)
    alphas, betas = recursions.ctc_alpha_beta(
        *(torch.from_numpy(x) for x in (lp, skip, in_lens, exp_lens)))
    for s in range(S):
        n = int(in_lens[s])
        _reachable(alphas.numpy()[:n, s], np.asarray(a_j)[:n, s],
                   f"alpha s={s}")
        _reachable(betas.numpy()[:n, s], np.asarray(b_j)[:n, s],
                   f"beta s={s}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grad_match_jax(case):
    logits, labels, in_lens, lab_lens = _case(*CASES[case], seed=2)
    args = [jnp.asarray(a) for a in (labels, in_lens, lab_lens)]
    (loss_j, aux_j), g_j = jax.value_and_grad(
        lambda lg: jax_ctc_batch_loss(lg, *args), has_aux=True)(
        jnp.asarray(logits))
    lt = torch.tensor(logits, requires_grad=True)
    loss, aux = ctc_batch_loss(lt, *[torch.from_numpy(a) for a in
                                     (labels, in_lens, lab_lens)])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TOL)
    for k in ("per_seq_nll", "frames", "loss_sum"):
        np.testing.assert_allclose(aux[k].detach().numpy(),
                                   np.asarray(aux_j[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-4)
    # frames past each input length get no gradient
    for s, n in enumerate(in_lens):
        assert np.abs(lt.grad.numpy()[s, n:]).max(initial=0.0) == 0.0


def test_matches_torch_ctc_loss():
    logits, labels, in_lens, lab_lens = _case(*CASES["torch"], seed=3)
    lt = torch.tensor(logits, requires_grad=True)
    got = ctc_loss(lt, torch.from_numpy(labels), torch.from_numpy(in_lens),
                   torch.from_numpy(lab_lens))
    got.sum().backward()
    ref_in = torch.tensor(logits, requires_grad=True)
    want = torch.nn.functional.ctc_loss(
        torch.log_softmax(ref_in, -1).transpose(0, 1),
        torch.from_numpy(labels).long(), torch.from_numpy(in_lens).long(),
        torch.from_numpy(lab_lens).long(), blank=0, reduction="none")
    want.sum().backward()
    torch.testing.assert_close(got.detach(), want.detach(), **TOL)
    torch.testing.assert_close(lt.grad, ref_in.grad, rtol=1e-3, atol=1e-4)


def test_expand_labels_and_spike_mask():
    exp = expand_labels(torch.tensor([[1, 2, 3]]))
    assert exp.tolist() == [[0, 1, 0, 2, 0, 3, 0]]
    rs = np.random.RandomState(4)
    nll = rs.rand(9).astype(np.float32) * 50
    nll[2] = np.inf
    nll[5] = 4000.0
    lens = rs.randint(5, 40, 9)
    for mode in ("avg", "sum", "none"):
        np.testing.assert_array_equal(
            ctc_loss_spike_mask(nll, lens, mode),
            jax_spike_mask(nll, lens, mode))
