"""The PyTorch port's loss composition and parameter regularizers against
the JAX package's, and the driver's `--l1-regularize`, `--l2-regularize`
and `--no-grouped-workers` on the CPU.

* `l1` (`sum |theta|`), `l2` (`sqrt(sum theta^2)`, the norm) and sums of
  scaled losses: names exactly, values and gradients with respect to
  theta within rtol 1e-6 (f32 sums over 1,000 values in another order),
  and the result's dtype with a bf16 output and f32 parameters.
* The driver runs the headline configuration of `tests/test_torch_cli.py`
  (3 steps, n=11, f=2, Bulyan against `empire(1.1)`) in process through
  the indexed path: plain, with `--l2-regularize 1e-2`, with
  `--l1-regularize 1e-4`, and with `--l2-regularize 1e-2
  --no-grouped-workers`. Every run takes the device-resident batches
  each step and evaluation, and the honest phase it was asked for. Step
  0 starts from the same weights, batches and dropout masks, so its
  average loss rises by exactly the regularizer's value at the initial
  weights (within atol 1e-6: the study prints 9 digits, the per-worker
  sums round in f32), and the vmapped run gives the grouped run's step 0
  within the engine tests' tolerance (rtol 1e-4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantinemomentum_tpu.losses import Loss as JaxLoss
from byzantinemomentum_tpu_torch import models, prng
from byzantinemomentum_tpu_torch.cli import attack as driver
from byzantinemomentum_tpu_torch.engine import STUDY_COLUMNS
from byzantinemomentum_tpu_torch.losses import Loss
from byzantinemomentum_tpu_torch.models import FlatParams

from tests.test_torch_cli import HEADLINE, SYNTH
from tests.torch_threads import one_torch_thread  # noqa: F401

COMPOSED = (
    ("l1", lambda L: L("l1")),
    ("l2", lambda L: L("l2")),
    ("nll+0.01*l2", lambda L: L("nll") + 0.01 * L("l2")),
    ("nll+0.5*l1+2.0*l2", lambda L: L("nll") + 0.5 * L("l1") + L("l2") * 2.0),
)


def _inputs():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 10)).astype(np.float32)
    out = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    y = rng.integers(0, 10, 4).astype(np.int32)
    theta = rng.standard_normal(1000).astype(np.float32)
    return out.astype(np.float32), y, theta


@pytest.mark.parametrize("name,build", COMPOSED, ids=[c[0] for c in COMPOSED])
def test_losses_and_composition_match_jax(name, build):
    out, y, theta = _inputs()
    ours, theirs = build(Loss), build(JaxLoss)
    assert ours.name == theirs.name == name
    th = torch.from_numpy(theta).requires_grad_()
    value = ours(torch.from_numpy(out), torch.from_numpy(y), th)
    (grad,) = torch.autograd.grad(value, th)
    jvalue, jgrad = jax.value_and_grad(
        lambda p: theirs(jnp.asarray(out), jnp.asarray(y), p))(jnp.asarray(theta))
    assert value.dtype == torch.float32
    np.testing.assert_allclose(value.item(), float(jvalue), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-7)


def test_callable_loss_and_dtype_promotion():
    out, y, theta = _inputs()

    def custom(output, target, params):
        return torch.sum(output) * 0.0 + torch.max(params)

    loss = Loss(custom) + Loss("l2")
    assert loss.name == "custom+l2" == (JaxLoss(custom) + JaxLoss("l2")).name
    th = torch.from_numpy(theta)
    np.testing.assert_allclose(
        loss(torch.from_numpy(out), torch.from_numpy(y), th).item(),
        theta.max() + np.sqrt(np.sum(theta.astype(np.float64) ** 2)), rtol=1e-6)
    with pytest.raises(TypeError):
        Loss("nll") + 3
    # A bf16 output with f32 parameters promotes to f32, as in JAX
    value = (Loss("nll") + 1e-2 * Loss("l2"))(
        torch.from_numpy(out).to(torch.bfloat16), torch.from_numpy(y), th)
    jvalue = (JaxLoss("nll") + 1e-2 * JaxLoss("l2"))(
        jnp.asarray(out, jnp.bfloat16), jnp.asarray(y), jnp.asarray(theta))
    assert value.dtype == torch.float32 and jvalue.dtype == jnp.float32


def _run(tmp_path, name, *extra):
    resdir = tmp_path / name
    summary = driver.run(["--device", "cpu", *HEADLINE, *extra,
                          "--result-directory", str(resdir)])
    rows = (resdir / "study").read_text().split(os.linesep)[1:]
    return summary, [dict(zip(STUDY_COLUMNS, row.split("\t"))) for row in rows]


def test_driver_regularizers_and_no_grouped_workers_on_cpu(tmp_path,
                                                           monkeypatch):
    for key, value in SYNTH.items():
        monkeypatch.setenv(key, value)
    runs = {name: _run(tmp_path, name, *extra) for name, extra in (
        ("plain", ()), ("l2", ("--l2-regularize", "1e-2")),
        ("l1", ("--l1-regularize", "1e-4")),
        ("vmapped", ("--l2-regularize", "1e-2", "--no-grouped-workers")))}
    for name, (summary, rows) in runs.items():
        honest = "vmapped_phases" if name == "vmapped" else "grouped_phases"
        assert summary["counts"] == {"indexed_steps": 3, honest: 3,
                                     "indexed_evals": 2,
                                     "multi_dispatches": 1}, name
        assert len(rows) == 3
        for row in rows:
            assert np.isfinite(float(row["Defense gradient norm"])), (name, row)
    model = models.build("empire-cnn", device="cpu")
    model.init(prng.PRNGKey(1))
    theta0 = FlatParams(model).flatten(dict(model.named_parameters())).detach()
    l2 = float(torch.sqrt(torch.sum(theta0 * theta0)))
    l1 = float(torch.sum(torch.abs(theta0)))

    def loss0(name):
        return float(runs[name][1][0]["Average loss"])

    np.testing.assert_allclose(loss0("l2") - loss0("plain"), 1e-2 * l2, atol=1e-6)
    np.testing.assert_allclose(loss0("l1") - loss0("plain"), 1e-4 * l1, atol=1e-6)
    for column in ("Average loss", "Sampled gradient norm"):
        np.testing.assert_allclose(float(runs["vmapped"][1][0][column]),
                                   float(runs["l2"][1][0][column]), rtol=1e-4)
    # The regularizer moves the trajectory: step 1 starts from other weights
    assert runs["l2"][1][1]["l2 from origin"] != runs["plain"][1][1]["l2 from origin"]
