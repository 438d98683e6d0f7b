"""Plain versions of the port's LSTM kernels against fdbm_tpu/ops/lstm.py, on
the CPU.

The JAX kernels run as tests/test_pallas_lstm.py runs them: Pallas in
interpret mode on the CPU, at its deliberately unaligned sizes (S = 37 or
21, B = 5, D = 24, H = 20), which the TPU kernels pad to 16-step chunks and
128 lanes and the port does not pad at all. The port's wrappers, given CPU
tensors, run their plain versions and launch nothing (the CUDA kernels are
held against those on the card: tests/test_torch_cuda.py). Inputs come from
numpy seeds. Tolerances are that file's: 2e-5 absolute on hidden states,
and rtol 1e-3 / atol 2e-5 on the gradients of dx, dW_ih, dW_hh and db
(``test_pallas_train_grads_match_scan``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdbm_tpu.ops import lstm as jlstm
from fdbm_tpu_torch import ops
from fdbm_tpu_torch.ops import lstm as plstm

S, B, D, H = 37, 5, 24, 20
NAMES = ("x", "w_ih", "w_hh", "bias")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions run many tiny products, and
    the test workers share the machine's cores (oversubscribed BLAS threads
    spin instead of working)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(s, b, d, hidden, dirs=(), seed=0):
    """x [S, B, D] and torch-style U(-1/sqrt(H), 1/sqrt(H)) weights, numpy."""
    rng = np.random.default_rng(seed)
    u = lambda *shape: (rng.uniform(-1, 1, shape) / np.sqrt(hidden)).astype(np.float32)
    x = rng.standard_normal((s, b, d)).astype(np.float32)
    return x, u(*dirs, d, 4 * hidden), u(*dirs, hidden, 4 * hidden), u(*dirs, 4 * hidden)


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("s", [S, 32])  # padded to 48 steps; a whole number of chunks
def test_bilstm_fused_forward_plain_matches_jax_kernel(s):
    args = _args(s, B, D, H, dirs=(2,))
    want = jlstm.bilstm_fused_forward(*map(jnp.asarray, args))
    n0 = ops.launch_counts()
    got = plstm.bilstm_fused_forward(*_torch(*args))
    assert ops.launch_counts() == n0  # CPU tensors: the plain version
    for g, w in zip(got, want):
        assert g.shape == (s, B, H)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_forward_plain_matches_jax_kernel(reverse):
    args = _args(21, B, D, H, seed=1)
    want = jlstm.lstm_forward_pallas(*map(jnp.asarray, args), reverse=reverse)
    got = plstm.lstm_forward(*_torch(*args), reverse=reverse)
    assert got.shape == (21, B, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@functools.partial(jax.jit, static_argnames="reverse")
def _jax_value_and_grads(cot, x, w_ih, w_hh, bias, reverse):
    """lstm_train_pallas (lstm_core's kernels) and the gradients of
    sum(h * cot) in one compiled program."""
    def loss(*args):
        return jnp.sum(jlstm.lstm_train_pallas(*args, reverse=reverse) * cot)

    return jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(x, w_ih, w_hh, bias)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_core_plain_grads_match_jax_kernel(reverse):
    args = _args(S, B, D, H, seed=2)
    cot = np.random.default_rng(9).standard_normal((S, B, H)).astype(np.float32)
    jval, jgrads = _jax_value_and_grads(jnp.asarray(cot), *map(jnp.asarray, args),
                                        reverse=reverse)
    targs = [t.requires_grad_(True) for t in _torch(*args)]
    n0 = ops.launch_counts()
    h = plstm.lstm_core(*targs, reverse=reverse)
    loss = (h * torch.as_tensor(cot)).sum()
    loss.backward()
    assert ops.launch_counts() == n0
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)
    for name, t, g in zip(NAMES, targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-3, atol=2e-5,
                                   err_msg=f"gradient of {name}")
    # The backward wrapper on CPU tensors is autograd through the plain
    # version: the same four gradients for the same cotangent.
    plain = plstm.lstm_core_bwd(*_torch(*args), torch.as_tensor(cot), reverse=reverse)
    for name, t, g in zip(NAMES, targs, plain):
        torch.testing.assert_close(g, t.grad, rtol=1e-5, atol=1e-6, msg=f"gradient of {name}")


@jax.jit
def _jax_bilstm_train(cot, x, w_ih, w_hh, bias):
    def loss(*args):
        return jnp.sum(jlstm.bilstm_pallas_train(*args) * cot)

    return jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(x, w_ih, w_hh, bias)


def test_bilstm_train_matches_jax_kernel():
    """bilstm_train ([S, N, D], both directions) against bilstm_pallas_train
    ([N, S, D]); without a gradient it takes lstm_core's primal
    (lstm_forward)."""
    x, w_ih, w_hh, bias = _args(19, 3, 12, 10, dirs=(2,), seed=3)
    cot = np.random.default_rng(8).standard_normal((3, 19, 20)).astype(np.float32)
    batch_major = lambda a: np.ascontiguousarray(a.transpose(1, 0, 2))
    jval, jgrads = _jax_bilstm_train(*map(jnp.asarray, (cot, batch_major(x), w_ih, w_hh,
                                                        bias)))
    targs = [t.requires_grad_(True) for t in _torch(x, w_ih, w_hh, bias)]
    out = plstm.bilstm_train(*targs)
    assert out.shape == (19, 3, 20)
    loss = (out.transpose(0, 1) * torch.as_tensor(cot)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)
    for name, t, g in zip(NAMES, targs, jgrads):
        got = batch_major(t.grad.numpy()) if name == "x" else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(g), rtol=1e-3, atol=2e-5,
                                   err_msg=f"gradient of {name}")
    with torch.no_grad():
        torch.testing.assert_close(plstm.bilstm_train(*targs), out.detach(), rtol=0, atol=0)
