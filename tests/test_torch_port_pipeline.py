"""The GPipe pipeline over ``pp`` in the port against the JAX package, on the
CPU over gloo (``torch_ranks.run_ranks``; the ranks' side in
``tests/model_parallel_workers.py``, the JAX side in ``tests/mp_oracle.py``).

- ``parallel.pipeline.pipeline_forward`` at pp=2 on the JAX pipeline test's
  tanh stack (8 layers), with 2 and 4 micro-batches, a micro-sliced aux,
  with and without the stage remat: the output and the gradients of the
  input and of every layer's (w, b) under sum(out ** 2), against the JAX
  ``pipeline_forward`` on 2 virtual devices and ``jax.grad`` of it, 1e-5;
  on 7 rows in 4 uneven micro-batches (which the JAX function does not
  take), against the JAX serial stack.
- The ``Trainer`` at pp=2 (the retrieval model, the vl classify model
  with its per-layer rel-pos tables under the stage remat, and the VL
  pretrain model, its student passes' per-sample bias following the
  micro-batches and its decoder whole) and at pp2 x fsdp2: every
  parameter's gradient, gathered to full, against ``jax.grad`` of the
  serial JAX model within 1e-4, and the first step's loss within 1e-6 of
  the serial run's (one process), as the JAX pipeline test holds it; with
  dropout and drop path on, the one-process run's gradients.
- pp2 x tp2: the same gradients, and a bundle saved there after the steps
  (every stage's layers, the ``tp`` slices gathered) holds the names of a
  one-process run and loads in one process with equal tensors.
- At pp2, pp2 x fsdp2 and pp2 x tp2, three ``train_step``s (clipped at
  norm 1), then ``valid_step`` on 7 rows, which the micro-batch count does
  not divide: each step's loss and gnorm, the validation metrics, and the
  bundle's parameters and Adam moments against the same steps in one
  process, 1e-5.
- ``cli/train.py`` at pp2 with 3 micro-batches (the train batches of 8 and
  the validation batches of 4 both uneven) against the same argv in
  one process: the logged losses, gnorms and accuracies, and validation's
  recalls.

Each spawn of ranks takes ~10-25 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)
from jax.sharding import Mesh

import mp_oracle as mo
import parallel_workers as pw
from one_peace_tpu.parallel.pipeline import pipeline_forward as jax_pipeline
from test_torch_port_train_cli import corpus, overrides, read_log  # noqa: F401 (fixture)
from torch_ranks import run_ranks

TOL = 1e-5
STEP_TOL = 1e-5  # test_torch_port_parallel.py's LOSS_TOL and PARAM_TOL
BATCHES = [mo.retrieval_batch(8, seed) for seed in range(3)]
RAGGED = mo.retrieval_batch(7, 3)  # 2 micro-batches: 7 rows, or pp2 x fsdp2's 4 and 3


def _stack_case(micro, aux, checkpoint, seed=0, layers=8, d=16, b=8):
    rs = np.random.RandomState(seed)
    return {"micro": micro, "checkpoint": checkpoint,
            "w": (rs.randn(layers, d, d) * 0.3).astype(np.float32),
            "b": (rs.randn(layers, d) * 0.1).astype(np.float32),
            "x": rs.randn(b, d).astype(np.float32),
            "aux": (rs.rand(b, d) > 0.3).astype(np.float32) if aux else None}


STACK_CASES = [_stack_case(2, False, False), _stack_case(4, True, False, seed=1),
               _stack_case(4, True, True, seed=2), _stack_case(4, True, True, seed=3, b=7)]


def _jax_stack(case):
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pp",))
    aux = None if case["aux"] is None else jnp.asarray(case["aux"])

    def body(lp, x, a, bcast=None):
        y = jnp.tanh(x @ lp["w"] + lp["b"])
        return y if a is None else y * a

    def serial(stacked, x):
        for i in range(len(case["w"])):
            x = body({"w": stacked["w"][i], "b": stacked["b"][i]}, x, aux)
        return x

    def loss(stacked, x):
        if len(case["x"]) % case["micro"]:  # uneven micro-batches: the serial stack
            out = serial(stacked, x)
        else:
            out = jax_pipeline(body, stacked, x, mesh, num_micro_batches=case["micro"],
                               batch_aux=aux, checkpoint_stages=case["checkpoint"])
        return jnp.sum(out ** 2), out

    stacked = {"w": jnp.asarray(case["w"]), "b": jnp.asarray(case["b"])}
    (_, out), (gs, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        stacked, jnp.asarray(case["x"]))
    return np.asarray(out), np.asarray(gx), np.asarray(gs["w"]), np.asarray(gs["b"])


@pytest.fixture(scope="module")
def cases():
    return {"vl": mo.Case("retrieval", mo.retrieval_batch(8, 0)),
            "classify": mo.Case("classify", mo.classify_batch(4, 1)),
            "pretrain": mo.Case("pretrain", mo.pretrain_batch(4, 1))}


@pytest.fixture(scope="module")
def pp2_runs(cases, tmp_path_factory):
    vl = cases["vl"].on(dict(dp=1, pp=2, pp_micro_batches=2))
    classify = cases["classify"].on(dict(dp=1, pp=2, pp_micro_batches=4), checkpoint=True)
    dropped = mo.with_dropout(cases["vl"], dict(dp=1, pp=2, pp_micro_batches=4))
    pretrain = cases["pretrain"].on(dict(dp=1, pp=2, pp_micro_batches=2))
    return run_ranks(2, mo.mw.run_jobs, [
        ("pipeline_cases", (STACK_CASES,)),
        ("full_gradients", ([vl, classify, dropped, pretrain],)),
        ("train_steps", (vl, BATCHES, RAGGED))],
        tmp_path=tmp_path_factory.mktemp("pp2"), timeout=240)


@pytest.mark.parametrize("index", range(len(STACK_CASES)))
def test_pipeline_forward_matches_jax(index, pp2_runs):
    out, gx, gw, gb = _jax_stack(STACK_CASES[index])
    for rank in pp2_runs:  # the whole output on every stage
        got = rank[0][index]
        np.testing.assert_allclose(got["out"], out, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["dx"], gx, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["dw"], gw, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["db"], gb, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def serial_steps(cases):
    """``BATCHES``' steps and ``RAGGED``'s validation in one process."""
    return mo.mw.train_steps(0, 1, dict(cases["vl"].port, layout={}), BATCHES, RAGGED)


def _assert_same_steps(runs, serial):
    """Every rank's per-step loss and gnorm and its validation metrics, and
    rank 0's bundle (parameters and Adam moments), against one process's;
    the first loss within 1e-6, as the JAX pipeline test holds it."""
    for rank in runs:
        assert abs(rank["metrics"][0]["loss"] - serial["metrics"][0]["loss"]) <= 1e-6
        for step, (got, want) in enumerate(zip(rank["metrics"], serial["metrics"], strict=True)):
            for key in ("loss", "gnorm"):
                assert got[key] == pytest.approx(want[key], rel=STEP_TOL, abs=STEP_TOL), \
                    (step, key)
        assert rank["valid"].keys() == serial["valid"].keys()
        for key, want in serial["valid"].items():
            assert rank["valid"][key] == pytest.approx(want, rel=STEP_TOL, abs=STEP_TOL), key
    bundle, want = runs[0]["bundle"], serial["bundle"]
    assert bundle["updates"] == want["updates"] == len(BATCHES)
    pairs = [(name, bundle["params"][name], w) for name, w in want["params"].items()]
    for name, moments in want["opt_state"]["state"].items():
        pairs += [((name, key), bundle["opt_state"]["state"][name][key], w)
                  for key, w in moments.items() if torch.as_tensor(w).ndim > 0]
    for name, got, w in pairs:
        w = torch.as_tensor(w).double()
        err = (torch.as_tensor(got).double() - w).norm() / max(float(w.norm()), 1e-12)
        assert err <= STEP_TOL, (name, float(err))


def _check(run, case):
    assert run["loss"] == pytest.approx(case.loss, rel=1e-5, abs=1e-5)
    mo.assert_grads_match(run["grads"], case)


def test_pp2_trainer_matches_jax_and_the_serial_run(pp2_runs, cases, serial_steps):
    """With dropout and drop path on, each micro-batch draws its rows'
    masks of the whole batch: the one-process run's loss and gradients."""
    vl, classify, dropped, pretrain = pp2_runs[0][1]
    _check(vl, cases["vl"])
    _check(classify, cases["classify"])
    _check(pretrain, cases["pretrain"])  # the encoder pipelined, the decoder whole
    mo.assert_same_run(dropped, mo.mw.full_gradients(
        0, 1, [mo.with_dropout(cases["vl"], {})])[0])
    # each stage holds its own layer of the two
    stage_layers = [{n.split(".")[3] for n in rank[1][0]["local_names"]
                     if n.startswith("encoder_wrapper.fusion.layers.")} for rank in pp2_runs]
    assert stage_layers == [{"0"}, {"1"}]
    _assert_same_steps([rank[2] for rank in pp2_runs], serial_steps)


def test_pp2_fsdp2_trainer_matches_jax_and_the_serial_run(cases, serial_steps, tmp_path):
    case = cases["vl"].on(dict(dp=1, fsdp=2, pp=2, pp_micro_batches=2))
    runs = run_ranks(4, mo.mw.run_jobs, [("full_gradients", ([case],)),
                                         ("train_steps", (case, BATCHES, RAGGED))],
                     tmp_path=tmp_path, timeout=240)
    _check(runs[0][0][0], cases["vl"])
    _assert_same_steps([rank[1] for rank in runs], serial_steps)


def test_pp2_tp2_bundle_loads_in_one_process(cases, serial_steps, tmp_path):
    case = cases["vl"].on(dict(dp=1, tp=2, pp=2, pp_micro_batches=2))
    runs = run_ranks(4, mo.mw.run_jobs, [("full_gradients", ([case],)),
                                         ("train_steps", (case, BATCHES, RAGGED))],
                     tmp_path=tmp_path, timeout=240)
    _check(runs[0][0][0], cases["vl"])
    _assert_same_steps([rank[1] for rank in runs], serial_steps)
    bundle = runs[0][1]["bundle"]
    one = mo.mw.build_trainer(dict(cases["vl"].port, layout={}))
    assert sorted(bundle["params"]) == sorted(n for n, _ in one.model.named_parameters())
    assert sorted(bundle["opt_state"]["state"]) == sorted(one._names)
    one.load_state_dict(bundle)
    back = one.state_dict()
    for name, value in bundle["params"].items():
        assert torch.equal(back["params"][name], value), name
    for name, moments in bundle["opt_state"]["state"].items():
        for key, value in moments.items():
            assert torch.equal(torch.as_tensor(back["opt_state"]["state"][name][key]),
                               torch.as_tensor(value)), (name, key)


def test_train_cli_at_pp2_matches_one_process(corpus, tmp_path):  # noqa: F811
    from one_peace_tpu_torch.cli import train

    logs = {}
    for pp in (1, 2):
        save = tmp_path / f"pp{pp}"
        argv = ["--device", "cpu"] + overrides(corpus, save, checkpoint__restore_file=corpus[
            "root"] / "model.pt", distributed__pp=pp, distributed__pp_micro_batches=3)
        if pp == 1:
            assert train.main(argv) == 0
        else:
            assert run_ranks(2, pw.train_cli, argv, tmp_path=tmp_path, timeout=240) == [0, 0]
        logs[pp] = {tag: read_log(save / "log.jsonl", tag) for tag in ("train_inner", "valid")}
    inner = [logs[pp]["train_inner"] for pp in (1, 2)]
    assert [x["step"] for x in inner[1]] == [x["step"] for x in inner[0]] == [1, 2, 3, 4]
    for got, want in zip(inner[1], inner[0]):
        for key in ("loss", "lr", "gnorm", "i2t_accuracy", "t2i_accuracy"):
            assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-5), (key, got)
    valid = [logs[pp]["valid"] for pp in (1, 2)]
    assert len(valid[1]) == len(valid[0]) >= 1
    for got, want in zip(valid[1], valid[0]):
        assert {k: v for k, v in got.items() if k.startswith(("txt_", "img_", "r_"))} == \
            {k: v for k, v in want.items() if k.startswith(("txt_", "img_", "r_"))}
