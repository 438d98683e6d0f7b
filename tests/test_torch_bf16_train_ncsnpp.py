"""bf16 training of NCSN++ and bf16 fine-tuning against fdbm_tpu's, on the
CPU: one ``ncsnpp_v2_5M`` training step and one fine-tuning step, with
``tests/test_torch_bf16_train.py``'s gates and control on the loss and on
every group of leaves. NCSN++ has no kernel on either package's path: its
convolutions and dense layers run in bf16 with fp32 GroupNorm statistics
and softmax, on fan-in-scale weights (``tests/test_torch_bf16.py``'s
``_fan_in``)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fdbm_tpu import losses as jlosses
from fdbm_tpu import sampling as jsampling
from fdbm_tpu_torch import losses as plosses
from fdbm_tpu_torch import model as pmodel
from fdbm_tpu_torch.utils.weights import backbone_state_dict_from_flax

from test_torch_bf16 import _fan_in
from test_torch_bf16_train import (BF16, MODEL, _audio, _bf16_weights_twin, _check,
                                   _float64_twin, _fp32_twin, _jax_fdbm, _step,
                                   _torch_threads)  # noqa: F401

# Gate 1's limits, 3x the readings noted beside each test.
TOLS = {"ncsnpp": {"loss": 2.6e-3, "grad": 0.18}, "finetune": {"loss": 8.8e-3, "grad": 0.2}}


def _ncsnpp_pair(monkeypatch, **kw):
    cfg = dict(MODEL, backbone="ncsnpp_v2_5M", **kw)
    jf = _jax_fdbm(monkeypatch, **cfg)
    params = _fan_in(jf.init_params(jax.random.PRNGKey(0)))
    pf = pmodel.FDBM(pmodel.FDBMConfig(compute_dtype="bfloat16", **cfg), device="cpu")
    assert pf.dnn.train_dtype == BF16 == pf.dnn.serve_dtype
    convert = lambda tree: backbone_state_dict_from_flax("ncsnpp_v2_5M", tree)
    pf.dnn.load_state_dict(convert(params))
    return jf, params, pf, convert


def test_bf16_ncsnpp_train_step_matches_jax(monkeypatch):
    """One ``loss_fn`` + gradient of ``ncsnpp_v2_5M`` (fan-in weights; 17
    bins read as 16, 8 frames). Readings: loss 8.7e-4 to JAX (1.1e-3 /
    2.1e-4 to float64), groups up to 6.0e-2 (port 1.1e-2 to 3.9e-2, JAX
    1.0e-2 to 4.2e-2 from float64). The bf16-weights fault: loss 1.9e-3 to
    JAX, groups up to 0.23 (the middle blocks miss gate 1), 6.5e-2 to 0.24
    from float64 (every group misses gate 2)."""
    jf, params, pf, convert = _ncsnpp_pair(monkeypatch)
    routes = _step(pf, jf, params, convert, *_audio(), jax.random.PRNGKey(4))
    _check(routes, TOLS["ncsnpp"])


def test_bf16_finetuning_step_matches_jax(monkeypatch):
    """One fine-tuning step at N=2 (``ode_ei``, the unroll's first call on
    the serving route in bf16, the last on the training route in bf16, the
    gradient through it) of ``ncsnpp_v2_5M``: its loss and gradients, from
    the same spectrograms and prior draw in both packages. The bridge is
    ``fm`` on ``ot``, whose first step is benign: the ``sb`` bridge's ``bb``
    schedule amplifies each call's rounding (x1 = 4713.5 x0 - 4712.8 y +
    0.33 est), which puts the port's fp32 unroll 1.2e-2 from float64 and
    leaves no room to tell bf16 from fp32. Readings: loss 2.9e-3 to JAX
    (8.8e-3 / 5.9e-3 to float64), groups up to 6.5e-2 (port 2.2e-2 to
    5.7e-2, JAX 2.2e-2 to 7.1e-2 from float64). The bf16-weights fault:
    loss 0.175 to JAX, groups up to 1.23, every quantity missing both
    gates."""
    jf, params, pf, convert = _ncsnpp_pair(monkeypatch, mode="finetuning", N=2,
                                           sampler_type="ode_ei", bridge="fm",
                                           noise_schedule="ot")
    key = jax.random.PRNGKey(5)
    x, y = (np.array(jf.audio_to_spec(jnp.asarray(a))) for a in _audio())
    z = np.array(jsampling.complex_normal_like(key, jnp.asarray(y)))

    def jloss(p):
        return jlosses.compute_loss(jf.loss_cfg, jf._finetune_unrolled(p, jnp.asarray(y), key),
                                    jnp.asarray(x))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)

    def port(f, cdt=torch.complex64):
        params = {n: p for n, p in f.dnn.named_parameters() if p.requires_grad}
        out = f._finetune_unrolled(torch.as_tensor(y).to(cdt), z=torch.as_tensor(z).to(cdt))
        loss = plosses.compute_loss(f.loss_cfg, out, torch.as_tensor(x).to(cdt))
        return loss.detach(), dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    routes = {"jax": (torch.as_tensor(np.float64(jl)), convert(jax.device_get(jg))),
              "bf16": port(pf), "fp32": port(_fp32_twin(pf)),
              "fault": port(_bf16_weights_twin(pf)),
              "f64": port(_float64_twin(pf), torch.complex128)}
    _check(routes, TOLS["finetune"])
