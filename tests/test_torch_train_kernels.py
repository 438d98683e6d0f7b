"""The plain versions of the port's training kernels against fdbm_tpu's
Pallas kernels, on the CPU.

The JAX kernels run as tests/test_gridrnn_train.py runs them: Pallas in
interpret mode on the CPU, at its own small shapes. Inputs come from numpy
seeds. The JAX kernels are exact on rows [3, L-1] only, so forward values
are compared there, and gradients under a cotangent that is zero outside
those rows (the only cotangents the model's crop produces). Tolerances are
that file's: 2e-4 on the forward and 5e-4 on the five gradients, and 1e-5
between the plain summed fold and JAX's ``grid_bilstm_fold``, the
tolerance JAX holds its training forward to against that kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdbm_tpu.ops.gridrnn import grid_bilstm_fold as jax_grid_bilstm_fold
from fdbm_tpu.ops.gridrnn_train import grid_fold_train_pair as jax_train_pair
from fdbm_tpu_torch import ops
from fdbm_tpu_torch.ops import gridrnn, gridrnn_train

KS = 4
NAMES = ("x", "w_ih", "w_hh", "bias", "w_deconv")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions run many tiny products, and
    the test workers share the machine's cores (oversubscribed BLAS threads
    spin instead of working)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(s_len, b, c, hidden, seed=0):
    """tests/test_gridrnn_train.py's _rand_args, as numpy."""
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((s_len, b, c)) * 0.5).astype(np.float32),
        (rng.standard_normal((2, KS * c, 4 * hidden)) * 0.2).astype(np.float32),
        (rng.standard_normal((2, hidden, 4 * hidden)) * 0.2).astype(np.float32),
        (rng.standard_normal((2, 4 * hidden)) * 0.2).astype(np.float32),
        (rng.standard_normal((2 * hidden, KS * c)) * 0.2).astype(np.float32),
    )


@jax.jit
def _jax_outputs_and_grads(cot, *args):
    """JAX's outputs and the VJP of sum((outf + outb)[3:L] * cot), one
    compiled program (Pallas in interpret mode)."""
    length = args[0].shape[0] - (KS - 1)
    (outf, outb), vjp = jax.vjp(jax_train_pair, *args)
    full = jnp.zeros_like(outf).at[3:length].set(cot)
    return outf, outb, vjp((full, full))


@pytest.mark.parametrize("s_len,b,c,hidden", [
    (29, 5, 8, 10),    # partial chunks in both JAX passes
    (14, 40, 8, 6),    # L=11: one forward chunk, five backward batch tiles
])
def test_train_pair_plain_matches_jax_kernel(s_len, b, c, hidden):
    args = _args(s_len, b, c, hidden)
    length = s_len - (KS - 1)
    cot = np.random.default_rng(99).standard_normal((length - 3, b, c)).astype(np.float32)
    joutf, joutb, jgrads = _jax_outputs_and_grads(jnp.asarray(cot), *map(jnp.asarray, args))

    targs = [torch.as_tensor(a).requires_grad_(True) for a in args]
    n0 = dict(ops.launch_counts())
    outf, outb = gridrnn_train.grid_fold_train_pair(*targs)
    assert ops.launch_counts() == n0  # CPU tensors: the plain version
    for got, want in ((outf, joutf), (outb, joutb)):
        assert got.shape == (s_len, b, c)
        np.testing.assert_allclose(got.detach().numpy()[3:length], np.asarray(want)[3:length],
                                   rtol=2e-4, atol=2e-4)
    ((outf + outb)[3:length] * torch.as_tensor(cot)).sum().backward()
    for name, t, g in zip(NAMES, targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=5e-4, atol=5e-4,
                                   err_msg=f"gradient of {name}")

    # The backward wrapper on CPU tensors is autograd through the plain
    # version: the same five gradients for the same cotangent.
    dout = torch.zeros(s_len, b, c)
    dout[3:length] = torch.as_tensor(cot)
    plain = gridrnn_train.grid_fold_train_pair_bwd(*map(torch.as_tensor, args), dout, dout)
    for name, t, g in zip(NAMES, targs, plain):
        torch.testing.assert_close(g, t.grad, rtol=1e-5, atol=1e-6, msg=f"gradient of {name}")


def test_bilstm_fold_plain_matches_jax_kernel():
    args = _args(35, 12, 16, 24, seed=7)
    want = np.asarray(jax_grid_bilstm_fold(*map(jnp.asarray, args)))
    got = gridrnn.grid_bilstm_fold(*map(torch.as_tensor, args)).numpy()
    length = 35 - (KS - 1)
    assert got.shape == want.shape == (35, 12, 16)
    np.testing.assert_allclose(got[3:length], want[3:length], rtol=1e-5, atol=1e-5)
    # the summed fold is the training pair summed
    outf, outb = gridrnn_train.grid_fold_train_pair_plain(*map(torch.as_tensor, args))
    np.testing.assert_allclose(got, (outf + outb).numpy(), rtol=0, atol=0)
