"""The port's bench and HBM stream probe against the JAX repo's, on the CPU.

  * `hbm_probe.chain` with K6's plain version against the JAX probe's
    `_chain(lambda v, x: x * v)` (the plain reference of `_pallas_scale`)
    at n = 9, 4 iterations, within 1e-6 (float32 sums of ~4);
  * `stream_scale` on a CPU tensor is exactly x * v and counts no launch;
  * the bench's train step at n = 8 / 2 layers against jax.value_and_grad of
    the JAX bench's loss (`bench.build_train_step`), both with the exact
    2^8 EBM support and the same parameters (`convert.from_jax_params`):
    1e-5 on the loss, 1e-4 relative L2 on the gradient;
  * the gate reports 0 when both arms are the plain versions (the CPU);
  * the 8q forward <H> is within 1e-5 relative of the f64 oracle;
  * the bench's JSON line and the probe's have their keys; the probe's
    CLI runs on the card only.

The kernels themselves run only on the card (`python3 chip_smoke.py`).
"""

import contextlib
import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import hbm_probe as j_probe
from qhbmlib_tpu.inference import ebm as jebm
from qhbmlib_tpu_torch import bench
from qhbmlib_tpu_torch import convert
from qhbmlib_tpu_torch.benchmarks import hbm_probe
from qhbmlib_tpu_torch.ops import _cuda

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# Small workloads of the same shape as the bench's (cut in n and depth).
SMALL = {"24q": dict(n=8, layers=2, samples=100, max_unique=8),
         "20q": dict(n=7, layers=2, samples=120, max_unique=16)}


def test_chain_matches_jax_chain():
  shape, iters = (2**(9 - 7), 128), 4
  want = float(j_probe._chain(lambda v, x: x * v, shape, iters)(
      jnp.float32(1.0001)))
  got = float(hbm_probe.chain(hbm_probe.stream_scale_plain, shape, iters)(
      torch.tensor(1.0001)))
  np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
  # The kernel's wrapper in the chain takes the plain version here.
  wrapped = float(hbm_probe.chain(
      lambda v, x: hbm_probe.stream_scale(x, v, 512), shape, iters)(
          torch.tensor(1.0001)))
  assert wrapped == got


def test_stream_scale_cpu_is_plain_and_other_devices_refused():
  rng = np.random.RandomState(0)
  x = torch.tensor(rng.normal(size=(4, 128)).astype(np.float32))
  v = torch.tensor([1.37], dtype=torch.float32)
  before = hbm_probe.stream_scale.launches
  assert torch.equal(hbm_probe.stream_scale(x, v, 2), x * v)
  assert hbm_probe.stream_scale.launches == before
  assert _cuda._lib is None  # nothing was built or loaded
  with pytest.raises(ValueError, match="unsupported device"):
    hbm_probe.stream_scale(x.to("meta"), v.to("meta"), 2)


def _jax_bench():
  spec = importlib.util.spec_from_file_location(
      "jax_bench_under_test", os.path.join(REPO, "bench.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def test_train_step_matches_jax_bench(monkeypatch):
  """One step of the port's bench against the JAX bench's jitted step at
  the same parameters, both on the exact support (no draw enters)."""
  monkeypatch.setenv("QHBM_MATMUL_PRECISION", "highest")
  monkeypatch.setattr(jebm, "BernoulliEnergyInference", functools.partial(
      jebm.BernoulliEnergyInference, exact=True))
  cfg = dict(n=8, layers=2, samples=200, max_unique=16)
  train_step, params, opt_state = _jax_bench().build_train_step(cfg)
  loss_j, grads_j, _, _ = train_step(params, opt_state,
                                     jax.random.PRNGKey(0))
  grad_j = np.concatenate([np.asarray(grads_j[k][0]).reshape(-1)
                           for k in ("theta", "phi")])
  h, _, step = bench.build_train_step(cfg, CPU, exact=True)
  h.set_params(convert.from_jax_params(
      jax.tree_util.tree_map(np.asarray, params), device=CPU))
  loss_t, grad_t = step()
  np.testing.assert_allclose(float(loss_t), float(loss_j), atol=1e-5)
  rel = np.linalg.norm(grad_t.numpy() - grad_j) / np.linalg.norm(grad_j)
  assert rel < 1e-4, rel
  assert np.abs(grad_j).max() > 1e-2  # non-trivial gradient


def test_precision_gate_is_zero_when_both_arms_are_plain():
  traj = {}
  bench.run_workload("small", SMALL["24q"], 3, CPU, traj)
  gate = bench.precision_gate(traj)
  assert gate == {"gate_loss_err": 0.0, "gate_grad_rel_err": 0.0,
                  "gate_reference": "plain", "gate_trajectory_steps": 3}


def test_oracle_forward_err_8q():
  out = bench.measure_oracle_forward_err(SMALL["24q"], CPU)
  assert out["forward_h_rel_err"] < 1e-5
  assert abs(out["forward_h"] - out["forward_h_f64_oracle"]) == (
      out["forward_h_abs_err"])


def test_bench_json_line_has_its_keys():
  paths = []

  @contextlib.contextmanager
  def path(name):
    paths.append(name)
    yield

  result = bench.run_bench(CPU, steps=1, workloads=SMALL, path=path)
  line = json.loads(json.dumps(result))
  assert line["metric"] == "vqt_train_steps_per_sec_24q"
  assert line["unit"] == "steps/s" and line["value"] > 0
  assert {"steps_per_sec_20q", "gate_loss_err", "gate_grad_rel_err",
          "gate_reference", "gate_trajectory_steps", "forward_h",
          "forward_h_f64_oracle", "forward_h_abs_err", "forward_h_rel_err",
          "pauli_expectations_per_sec_20q", "hbm_probe", "workload",
          "qmhl_steps_per_sec_24q", "qmhl_gate_loss_err",
          "qmhl_gate_grad_rel_err", "qmhl_shards_rel_err", "workload_qmhl",
          "device", "card"} <= set(line["extra"])
  assert line["extra"]["device"] == "cpu" and line["extra"]["card"] is None
  assert paths == ["train 24q", "train 20q", "train qmhl 24q", "pauli 20q",
                   "probe"]


def test_probe_main_prints_the_reference_shape():
  out = json.loads(json.dumps(hbm_probe.measure(9, 2, device="cpu")))
  assert out["qubits"] == 9
  assert out["traffic_gb"] == 2 * 4 * 128 * 4 / 1e9
  # Off the card only the plain multiply runs; the kernel needs CUDA.
  assert set(out["results"]) == {"torch_scale"}
  assert set(out["results"]["torch_scale"]) == {"ms", "gb_per_s"}
  # The CLI runs on the card only: without one it raises resolve's error.
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="no CUDA device"):
      hbm_probe.main(["--qubits", "9", "--iters", "2"])
