"""The port's data parallelism against one process and against fdbm_tpu, on the CPU.

Two processes joined over gloo (``fdbm_tpu_torch.parallel``), started as
subprocesses that rendezvous through a ``file://`` store under ``tmp_path``
(no port to race for), or by the training CLI's ``-D 2`` itself. A narrow
TF-GridNet (1 block, C=16, H=24) at n_fft 128 and 32 frames, a global batch
of 4 rows, 2 a process:

* the 2-process step (one all-reduce of the loss and the gradients over the
  global batch's draw) against the 1-process step on the whole batch: on
  JAX's ``(t, z)`` draw, the loss to rel 1e-5 and every gradient to
  norm-rel 1e-3 (floor 1e-4 of the global norm) of JAX's
  ``FDBM.loss_fn`` gradients on the same weights (tests/test_torch_train.py's
  gates; the counterpart of tests/test_multihost.py), and of the port's
  one process within fp32 reduction order; on the port's own draws two
  steps of ``data_parallel_train_step`` against two of ``FDBM.train_step``
  on one generator, the parameters and EMA equal on both processes;
* ``all_gather_host_metrics`` with process 1's evaluation shard empty;
* ``-D 2 --device cpu`` through ``fdbm_tpu_torch.train.main`` against
  ``-D 1``; batch-split serving on two CPU replicas against one, row for
  row; the folder's file shards; the refusals (an indivisible batch, a
  partial ``initialize``, more devices than are visible).

And the trainer's repaired flags: every option of the root ``train.py`` /
``train_finetuning.py`` parsers (read with ``ast``, no JAX run starts) is
one of the port's, ``--profile_steps`` writes a trace and ``--nolog`` no
code snapshot, and ``param_dtype: bfloat16`` builds in both packages and
takes the same fp32 step.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdbm_tpu import model as jmodel
from fdbm_tpu.models import tfgridnet as jtfg
from fdbm_tpu_torch import infer as pinfer
from fdbm_tpu_torch import infer_folder as pinfer_folder
from fdbm_tpu_torch import model as pmodel
from fdbm_tpu_torch import sampling as psampling
from fdbm_tpu_torch import train as ptrain
from fdbm_tpu_torch import train_finetuning as ptrain_ft
from fdbm_tpu_torch.config import load_config
from fdbm_tpu_torch.models.tfgridnet import TFGridNet
from fdbm_tpu_torch.parallel import distributed, mesh
from fdbm_tpu_torch.utils.audio import read_wav, write_wav
from fdbm_tpu_torch.utils.weights import tfgridnet_from_flax

REPO = Path(__file__).resolve().parents[1]
NET = dict(n_layers=1, emb_dim=16, hidden=24)
MODEL = dict(n_fft=128, hop_length=64, num_frames=32)
ROWS = 4
SAMPLES = (MODEL["num_frames"] - 1) * MODEL["hop_length"]

WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(1)
    from fdbm_tpu_torch import model as pmodel
    from fdbm_tpu_torch.models.tfgridnet import TFGridNet
    from fdbm_tpu_torch.parallel import distributed, mesh

    task, rank, store, inp, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4], \\
        sys.argv[5]
    distributed.initialize(f"file://{{store}}", 2, rank, backend="gloo")
    assert distributed.process_index() == rank and distributed.process_count() == 2
    if task == "metrics":
        # Process 0 scored 3 files for si_sdr and 2 for pesq (one PESQ
        # failed); process 1's share of the evaluation files was empty.
        if rank == 0:
            got = distributed.all_gather_host_metrics(
                {{"valid_loss": 2.0, "si_sdr": 10.0, "pesq": 3.0}},
                {{"valid_loss": 4, "si_sdr": 3, "pesq": 2}}, distributed.VALID_METRIC_SCHEMA)
        else:
            got = distributed.all_gather_host_metrics({{}}, {{}}, distributed.VALID_METRIC_SCHEMA)
        json.dump(got, open(f"{{out}}.{{rank}}.json", "w"))
    else:
        blob = torch.load(inp, weights_only=True)
        fdbm = pmodel.FDBM(pmodel.FDBMConfig(**blob["model"]), device="cpu")
        fdbm.dnn = TFGridNet(**blob["net"])
        fdbm.dnn.load_state_dict(blob["weights"])
        state = pmodel.TrainState(fdbm.dnn)
        local = mesh.shard_batch(blob["batches"][0], rank, 2)
        loss, grads = mesh.data_parallel_grads(fdbm, state, local, prior=blob["prior"])
        res = {{"loss": loss, "grads": grads}}
        # Two steps on the port's own draws, on a fresh state.
        fdbm.dnn.load_state_dict(blob["weights"])
        state = pmodel.TrainState(fdbm.dnn)
        gen = torch.Generator().manual_seed(5)
        res["metrics"] = [mesh.data_parallel_train_step(fdbm, state,
                                                        mesh.shard_batch(b, rank, 2), gen)
                          for b in blob["batches"]]
        res["params"] = fdbm.dnn.state_dict()
        res["ema"] = state.ema
        torch.save(res, f"{{out}}.{{rank}}.pt")
    distributed.shutdown()
""").format(repo=str(REPO))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _two_processes(tmp_path, task, inp=""):
    """Run the worker's ``task`` in two processes; returns their out prefix."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    store, out = tmp_path / f"{task}.store", tmp_path / task
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(script), task, str(r), str(store), str(inp),
                               str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"process {r}:\n{logs[r]}"
    return out


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((ROWS, SAMPLES))).astype(np.float32)
    y = (x + 0.02 * rng.standard_normal((ROWS, SAMPLES))).astype(np.float32)
    return x, y


def _jax_model(**cfg):
    jf = jmodel.FDBM(jmodel.FDBMConfig(**MODEL, **cfg))
    jf.dnn = jf.dnn_sample = jtfg.TFGridNet(**NET)
    params = jf.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.device_get(params))
    return jf, params


def _port_model(weights, **cfg):
    pf = pmodel.FDBM(pmodel.FDBMConfig(**MODEL, **cfg), device="cpu")
    pf.dnn = TFGridNet(**NET)
    pf.dnn.load_state_dict(weights)
    return pf


def _jax_draw_and_grads(jf, params, x, y, key):
    t, _, z, _ = jf._sample_prior(key, jf.audio_to_spec(jnp.asarray(x)),
                                  jf.audio_to_spec(jnp.asarray(y)))
    jloss, jgrads = jax.jit(jax.value_and_grad(jf.loss_fn))(
        params, (jnp.asarray(x), jnp.asarray(y)), key)
    prior = (torch.as_tensor(np.array(t)), torch.as_tensor(np.array(z)))
    return prior, float(jloss), jgrads


def _hold_to_jax(loss, grads, jloss, jgrads):
    sd = tfgridnet_from_flax(jax.device_get(jgrads))
    _hold(loss, grads, jloss, {k: sd[k] for k in grads})


def _hold(loss, grads, want_loss, want):
    """tests/test_torch_train.py's gates: the loss to rel 1e-5, each
    gradient to norm-rel 1e-3 with the denominator floored at 1e-4 of the
    global norm."""
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss, want_loss)
    gnorm = float(np.sqrt(sum(float((w * w).sum()) for w in want.values())))
    for name, g in grads.items():
        rel = float((g - want[name]).norm()) / max(float(want[name].norm()), 1e-4 * gnorm)
        assert rel < 1e-3, (name, rel)


def test_two_process_step_matches_one_process_and_jax(tmp_path):
    jf, params = _jax_model()
    weights = tfgridnet_from_flax(params)
    batches = [tuple(map(torch.as_tensor, _batch(s))) for s in (0, 1)]
    x, y = (b.numpy() for b in batches[0])
    prior, jloss, jgrads = _jax_draw_and_grads(jf, params, x, y, jax.random.PRNGKey(3))
    inp = tmp_path / "inputs.pt"
    torch.save({"model": MODEL, "net": NET, "weights": weights, "batches": batches,
                "prior": prior}, inp)
    out = _two_processes(tmp_path, "step", inp)
    ranks = [torch.load(f"{out}.{r}.pt", weights_only=True) for r in range(2)]

    # The all-reduced loss and gradients: the same on both processes, JAX's
    # on the whole batch, and the port's one process on the whole batch.
    assert ranks[0]["loss"] == ranks[1]["loss"]
    for name, g in ranks[0]["grads"].items():
        assert torch.equal(g, ranks[1]["grads"][name]), name
    _hold_to_jax(ranks[0]["loss"], ranks[0]["grads"], jloss, jgrads)
    one = _port_model(weights)
    state = pmodel.TrainState(one.dnn)
    loss = one.loss_fn(batches[0], prior=prior)
    grads = torch.autograd.grad(loss, list(state.params.values()))
    _hold(ranks[0]["loss"], ranks[0]["grads"], float(loss.detach()),
          dict(zip(state.params, grads)))

    # Two steps on the port's own draws of one generator: the global draw
    # sliced by rank is the one-process step's draw.
    gen = torch.Generator().manual_seed(5)
    one = _port_model(weights)
    state = pmodel.TrainState(one.dnn)
    metrics = [one.train_step(state, b, gen) for b in batches]
    for m, m2 in zip(metrics, ranks[0]["metrics"]):
        assert m2["train_loss"] == pytest.approx(m["train_loss"], rel=1e-6)
        assert m2["grad_norm"] == pytest.approx(m["grad_norm"], rel=1e-5)
    for name in weights:
        assert torch.equal(ranks[0]["params"][name], ranks[1]["params"][name]), name
        assert torch.equal(ranks[0]["ema"][name], ranks[1]["ema"][name]), name
    _same_move(weights, ranks[0]["params"], one.dnn.state_dict())
    _same_move(weights, ranks[0]["ema"], state.ema)


def _same_move(start, got, want, tol=5e-2):
    """``got`` and ``want`` moved alike from ``start``: over all leaves,
    the distance between the moves within ``tol`` of the move. Adam's first
    steps are about lr * sign(g) an element, so an element whose gradient
    is near 0 can move the other way when the gradient is summed in another
    order (k of n elements: about 2 sqrt(k / n) of the move; one element of
    this net's 50k reads 2.5e-3): the moves are held as a whole, not element
    by element. The steps' losses and gradient norms are held tightly."""
    diff = sum(float(((got[k] - want[k]).double() ** 2).sum()) for k in start)
    move = sum(float(((want[k] - start[k]).double() ** 2).sum()) for k in start)
    assert move > 0 and diff <= tol ** 2 * move, (np.sqrt(diff), np.sqrt(move))


def test_metric_gather_with_an_empty_process_shard(tmp_path):
    out = _two_processes(tmp_path, "metrics")
    got = [json.loads(Path(f"{out}.{r}.json").read_text()) for r in range(2)]
    assert got[0] == got[1] == {"valid_loss": 2.0, "si_sdr": 10.0, "pesq": 3.0}


def test_partial_initialize_raises():
    with pytest.raises(ValueError, match="all of init_method"):
        distributed.initialize("file:///nowhere", num_processes=2)
    with pytest.raises(ValueError, match="all of init_method"):
        distributed.initialize(process_id=0)
    assert distributed.process_count() == 1 and distributed.process_index() == 0


def test_shard_batch_and_mesh():
    batch = (np.arange(8).reshape(4, 2), np.arange(4))
    assert [s[1].tolist() for s in (mesh.shard_batch(batch, r, 2) for r in range(2))] == \
        [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(batch, 0, 3)
    assert mesh.make_mesh(2, devices=["cpu"] * 3) == [torch.device("cpu")] * 2
    assert mesh.make_mesh(devices=["cpu"] * 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="Requested 3 devices, have 2"):
        mesh.make_mesh(3, devices=["cpu", "cpu"])


def _write_pairs(base, subset, lengths, seed, same=False):
    rng = np.random.default_rng(seed)
    for kind in ("clean", "noisy"):
        os.makedirs(os.path.join(base, subset, kind), exist_ok=True)
    for i, n in enumerate(lengths):
        r = np.random.default_rng(seed) if same else rng
        x = (0.3 * np.sin(np.arange(n) * 0.02 * (1 if same else i + 1))).astype(np.float32)
        y = (x + 0.05 * r.standard_normal(n)).astype(np.float32)
        write_wav(os.path.join(base, subset, "clean", f"{i:03d}.wav"), x, 16000)
        write_wav(os.path.join(base, subset, "noisy", f"{i:03d}.wav"), y, 16000)


TINY = """mode: generative
backbone: tfgridnet_4l32c80
bridge: sb
noise_schedule: bb
sampler_type: sde_ei
N: 2
loss_type: data_prediction_hybrid
base_dir: {base}
batch_size: 2
n_fft: 32
hop_length: 16
num_frames: 8
num_workers: 1
log_dir: {base}/logs
scheduler_config:
  scheduler: warmup
  config:
    warmup_steps: 2
    decay_until_step: 100
    max_lr: 5.0e-4
    min_lr: 5.0e-6
"""


def test_cli_two_processes_match_one(tmp_path, monkeypatch):
    """``-D 2 --device cpu`` against ``-D 1``: 2 steps, one a 1-batch epoch,
    each followed by the valid loss and the evaluation of 2 files (one a
    process). The training files are alike (one 112-sample crop, cropped
    nowhere), so each process's ``[rank::2]`` file share makes the same
    global batch as one process's shuffle; the steps, the draws and the
    evaluation's split-off generator then give the same ``last`` weights.
    Process 0 alone writes the run: two valid lines, the samples of its own
    file, one code snapshot."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    base = str(tmp_path)
    _write_pairs(base, "train", [112, 112], seed=0, same=True)
    _write_pairs(base, "valid", [1100, 1100], seed=1)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY.format(base=base))
    runs = {}
    for d in (1, 2):
        runs[d] = Path(ptrain.main(["-C", str(cfg), "--device", "cpu", "-D", str(d),
                                    "--max_steps", "2", "num_eval_files=2", f"version=d{d}"]))
    lasts = {d: torch.load(r / "checkpoints" / "last.pt", weights_only=True)
             for d, r in runs.items()}
    assert lasts[1]["train_state"]["step"] == lasts[2]["train_state"]["step"] == 2
    torch.manual_seed(0)  # the CLI's --seed: its initial weights
    start = ptrain.build_from_config(load_config(str(cfg)), "cpu")[0].dnn.state_dict()
    _same_move(start, lasts[2]["state_dict"], lasts[1]["state_dict"])
    _same_move(start, lasts[2]["train_state"]["ema"], lasts[1]["train_state"]["ema"])
    for d, run in runs.items():
        records = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
        assert len(records) == 2 and all({"valid_loss", "si_sdr", "pesq"} <= set(r)
                                         for r in records), records
        samples = sorted(os.listdir(run / "valid_samples"))
        files = {"000", "001"} if d == 1 else {"000"}
        assert {s[:3] for s in samples} == files and len(samples) == 4 * len(files)
        assert (run / "code" / "fdbm_tpu_torch" / "train.py").exists()
    assert sorted(os.listdir(tmp_path / "logs")) == sorted(r.name for r in runs.values())


def _tiny_fdbm(**cfg):
    torch.manual_seed(0)
    return pmodel.FDBM(pmodel.FDBMConfig(backbone="tfgridnet_4l32c80", n_fft=64, hop_length=32,
                                         **cfg), device="cpu")


def test_split_serving_matches_one_device_row_for_row():
    """Two CPU replicas against one device on the same generator: the
    sampler's draws are made for the whole batch in its order
    (``Bridge.draws``), so every row sees the noise it sees unsplit."""
    fdbm = _tiny_fdbm()
    rng = np.random.default_rng(2)
    audios = [(0.2 * rng.standard_normal(n)).astype(np.float32)
              for n in (3000, 2500, 2000, 1800, 1500, 1200, 1000, 900)]
    for sampler, kwargs in (("sde_ei", {}), ("ode_ei", {}),
                            ("pc", dict(predictor_name="euler_maruyama"))):
        common = dict(sampler_type=sampler, N=2, batch_size=4, sampler_kwargs=kwargs)
        one = pinfer.BucketedEnhancer(fdbm, **common)
        split = pinfer.BucketedEnhancer(fdbm, devices=["cpu", "cpu"], **common)
        assert split.split is not None
        want = one.enhance_many(audios, torch.Generator().manual_seed(7))
        got = split.enhance_many(audios, torch.Generator().manual_seed(7))
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape
            assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), (sampler, i)


def test_split_folder_matches_one_device(tmp_path, monkeypatch):
    """``enhance_folder`` on 7 files (a remainder batch, which split serving
    runs at the full batch size) with every draw zero, as
    tests/test_torch_folder.py holds it."""
    monkeypatch.setattr(psampling, "complex_normal_like",
                        lambda x, generator=None: torch.zeros_like(x, dtype=torch.complex64))
    fdbm = _tiny_fdbm()
    noisy = tmp_path / "noisy"
    noisy.mkdir()
    rng = np.random.default_rng(3)
    for i in range(7):
        write_wav(str(noisy / f"f{i}.wav"),
                  (0.2 * rng.standard_normal(int(rng.integers(900, 4000)))).astype(np.float32),
                  16000)
    common = dict(sampler_type="sde_ei", N=2, batch_size=4, progress=False, chunk_seconds=0)
    one = pinfer.enhance_folder(fdbm, str(noisy), str(tmp_path / "one"), **common)
    split = pinfer.enhance_folder(fdbm, str(noisy), str(tmp_path / "split"),
                                  devices=["cpu", "cpu"], **common)
    assert one.files == split.files == 7 and one.failures == split.failures == 0
    for i in range(7):
        a, _ = read_wav(str(tmp_path / "split" / f"f{i}.wav"))
        b, _ = read_wav(str(tmp_path / "one" / f"f{i}.wav"))
        assert a.shape == b.shape and np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), i


def test_folder_shards_union_and_disjoint(tmp_path):
    fdbm = _tiny_fdbm()
    noisy = tmp_path / "noisy"
    (noisy / "sub").mkdir(parents=True)
    rng = np.random.default_rng(4)
    names = [f"sub/f{i}.wav" if i % 3 == 2 else f"f{i}.wav" for i in range(7)]
    for name in names:
        write_wav(str(noisy / name), (0.2 * rng.standard_normal(1000)).astype(np.float32), 16000)
    out = tmp_path / "out"
    stats = [pinfer.enhance_folder(fdbm, str(noisy), str(out), sampler_type="sde_ei", N=1,
                                   batch_size=2, progress=False, process_index=r,
                                   process_count=2) for r in range(2)]
    assert [s.files for s in stats] == [4, 3] and sum(s.failures for s in stats) == 0
    written = sorted(str(p.relative_to(out)) for p in out.rglob("*.wav"))
    assert written == sorted(names)
    shards = [set(pinfer.shard_files(sorted(names), r, 2)) for r in range(2)]
    assert not shards[0] & shards[1] and shards[0] | shards[1] == set(names)


def test_refusals(tmp_path):
    fdbm = _tiny_fdbm()
    with pytest.raises(ValueError, match="must divide"):
        pinfer.BucketedEnhancer(fdbm, batch_size=3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="whole batch"):
        pinfer.BucketedEnhancer(fdbm, sampler_type="ode_int", batch_size=2,
                                devices=["cpu", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY.format(base=tmp_path))
    # More cards than are visible (none here): -D and --mesh_devices raise
    # before anything starts.
    for cli in (ptrain, ptrain_ft):
        with pytest.raises(ValueError, match="Requested 2 devices, have 0"):
            cli.main(["-C", str(cfg), "-D", "2", "ckpt=unused"])
    with pytest.raises(ValueError, match="Requested 2 devices, have 0"):
        pinfer_folder.main(["-C", str(REPO / "configs" / "config_infer_folder.yaml"),
                            "--mesh_devices", "2", "ckpt=unused"])


def _root_options(script):
    """The option strings of every ``add_argument`` call in a root CLI."""
    tree = ast.parse((REPO / script).read_text())
    return {a.value for node in ast.walk(tree) if isinstance(node, ast.Call)
            and getattr(node.func, "attr", "") == "add_argument"
            for a in node.args if isinstance(a, ast.Constant) and str(a.value).startswith("-")}


@pytest.mark.parametrize("script,port", [("train.py", ptrain), ("train_finetuning.py", ptrain_ft)])
def test_port_parsers_take_every_root_option(script, port):
    root = _root_options(script)
    assert {"-C", "-D", "--max_steps"} <= root
    assert root <= set(port.build_parser()._option_string_actions)


def test_profile_steps_and_nolog(tmp_path):
    """``-D 1 --profile_steps 1 2 --nolog`` on the config.yaml CLI surface
    (tiny overrides): a Chrome trace of steps 1-2 under <run>/profile, no
    <run>/code; without --nolog the snapshot is there."""
    base = str(tmp_path)
    _write_pairs(base, "train", [300, 260, 400, 350], seed=0)
    _write_pairs(base, "valid", [300], seed=1)
    args = ["-C", str(REPO / "configs" / "config.yaml"), "--device", "cpu", "--max_steps", "2",
            f"base_dir={base}", f"log_dir={base}/logs", "backbone=tfgridnet_4l32c80",
            "n_fft=32", "hop_length=16", "num_frames=8", "batch_size=2", "num_workers=1",
            "num_eval_files=0"]
    run = Path(ptrain.main(args + ["-D", "1", "--profile_steps", "1", "2", "--nolog",
                                   "version=prof"]))
    trace = run / "profile" / "steps_1-2.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert events and not (run / "code").exists()
    assert (run / "checkpoints" / "last.pt").exists()
    run = Path(ptrain.main(args + ["--max_steps", "1", "version=snap"]))
    assert (run / "code" / "fdbm_tpu_torch" / "train.py").exists()
    assert (run / "code" / "train.py").exists() and not (run / "profile").exists()


def test_param_dtype_bfloat16_builds_and_trains_fp32():
    """The JAX package declares ``param_dtype`` and reads it nowhere; the
    port accepts it the same way: both build, keep fp32 parameters and take
    the same step (tests/test_torch_train.py's gates)."""
    jf, params = _jax_model(param_dtype="bfloat16")
    assert all(np.asarray(a).dtype == np.float32 for a in jax.tree_util.tree_leaves(params))
    pf = _port_model(tfgridnet_from_flax(params), param_dtype="bfloat16")
    assert pf.serve_dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in pf.dnn.parameters())
    x, y = _batch(0)
    prior, jloss, jgrads = _jax_draw_and_grads(jf, params, x, y, jax.random.PRNGKey(4))
    state = pmodel.TrainState(pf.dnn)
    loss = pf.loss_fn(pf.to_device((x, y)), prior=prior)
    grads = dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values()))))
    _hold_to_jax(float(loss.detach()), grads, jloss, jgrads)
