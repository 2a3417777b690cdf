"""The harness's experiment configuration (port of `baselines/config.py`,
without `ml_collections`): the same keys and defaults in a `ConfigDict`,
a dict whose keys read and write as attributes, so the trainer reads
`config.dataset.num_rows` as the reference's does.

    python -m qhbmlib_tpu_torch.baselines.train \\
        --config qhbmlib_tpu_torch/baselines/config.py \\
        --config.dataset.num_rows=8 --config.dataset.num_cols=1
"""

from __future__ import annotations

import datetime
import itertools
import os.path


class ConfigDict(dict):
  """A dict whose keys are also attributes; nested dicts become
  ConfigDicts."""

  def __init__(self, *args, **kwargs):
    super().__init__()
    for key, value in dict(*args, **kwargs).items():
      self[key] = value

  def __setitem__(self, key, value):
    if isinstance(value, dict) and not isinstance(value, ConfigDict):
      value = ConfigDict(value)
    super().__setitem__(key, value)

  def __getattr__(self, key):
    try:
      return self[key]
    except KeyError:
      raise AttributeError(key) from None

  def __setattr__(self, key, value):
    self[key] = value

  def to_dict(self) -> dict:
    """A plain nested dict copy."""
    return {k: v.to_dict() if isinstance(v, ConfigDict) else v
            for k, v in self.items()}


def get_config() -> ConfigDict:
  """The configuration of one experiment (reference
  `baselines/config.py:11-93`)."""
  config = ConfigDict()
  config.experiment_name = (
      "qhbm_experiment_" +
      datetime.datetime.today().strftime("%Y-%m-%d-%H-%M-%S"))

  # dataset generation settings
  dataset = ConfigDict()
  dataset.num_rows = 2
  dataset.num_cols = 2
  dataset.lattice_dim = 1
  dataset.bias = 1.0
  dataset.beta = 1.0
  dataset.beta_min = 0.5
  dataset.beta_max = 2.25
  dataset.beta_steps = 4
  dataset.total_time = 3.0
  dataset.time_steps = 3
  dataset.trotter_steps = 1
  dataset.digits = 3
  config.dataset = dataset

  model = ConfigDict()
  model.energy = "kobe"  # 'kobe' | 'bernoulli'
  model.kobe_order = 2
  model.ebm = "analytic"  # 'analytic' | 'bernoulli' | 'gwg'
  model.energy_init_mean = 0.0
  model.energy_init_stddev = 0.1
  model.circuit = "qhea"  # 'qhea' | 'qaia'
  model.circuit_layers = 7
  model.circuit_init_mean = 0.0
  model.circuit_init_stddev = 0.1
  model.qnn = "analytic"  # 'analytic' | 'sampled'
  # GWG-specific knobs (unused for other EBMs).
  model.gwg_burnin = 100
  model.gwg_chains = 32
  config.model = model

  # training settings
  training = ConfigDict()
  # If False, only simulate the dataset (no model training)
  training.train = True
  training.num_trials = 1
  training.loss = "vqt"  # 'vqt' | 'qvartz'
  training.method = "vanilla"  # 'vanilla' | 'natural' | 'mirror'
  training.optimizer = "Adam"  # 'SGD' | 'Adam'
  training.learning_rate = 0.1
  training.inner_learning_rate = 2.5e-3
  training.init_steps = 1000
  training.num_steps = 100
  training.num_inner_steps = 100
  training.num_samples = 500
  training.seq_init = "prev"  # 'prev' | 'random'
  training.resume = True  # restore finished data points from checkpoints
  training.info_matrix_reg = 1.0
  training.info_matrix_eigval_reg = True
  training.lstsq_fast = False
  training.lstsq_l2_regularizer = 1e-2
  training.euclidean_div_factor = 0.5
  config.training = training

  # logging settings
  logging = ConfigDict()
  logging.loss = True
  logging.variables = True
  logging.grads = True
  logging.norm_ord = 2
  logging.fidelity = True
  logging.relative_entropy = True
  logging.density_matrix = False
  logging.info_matrix = True
  logging.reg_info_matrix = True
  logging.natural_grads = True
  logging.inner_loss = True
  logging.inner_prod = True
  logging.div = True
  logging.inner_loss_grads = True
  logging.expensive_downsample = 1
  logging.tensorboard = True  # JSONL metrics are always written.
  logging.checkpoint = True  # torch.save checkpoints of trained parameters.
  logging.profiler_steps = 0  # >0: capture a torch.profiler trace of N steps.
  config.logging = logging

  config.args = {
      "experiment_name": config.experiment_name,
      "output_dir": "/tmp/qhbm_logs/{}".format(config.experiment_name),
      "config": os.path.basename(__file__),
      "seed": 42,
  }
  return config


def get_sweep():
  """The Cartesian sweep over loss x method x optimizer x seq_init, one
  dict of dotted overrides a point (reference `baselines/config.py:96`)."""
  loss = ["vqt", "qvartz"]
  method = ["vanilla", "natural", "mirror"]
  optimizer = ["SGD", "Adam"]
  seq_init = ["random", "prev"]
  return list(
      dict([("config.training.loss", l), ("config.training.method", m),
            ("config.training.optimizer", o), ("config.training.seq_init", i)])
      for (l, m, o, i) in itertools.product(loss, method, optimizer, seq_init))
