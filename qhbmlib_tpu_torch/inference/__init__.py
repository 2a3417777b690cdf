"""Inference engines and the VQT loss."""

from qhbmlib_tpu_torch.inference.ebm import BernoulliEnergyInference
from qhbmlib_tpu_torch.inference.ebm import EnergyInference
from qhbmlib_tpu_torch.inference.qhbm import QHBM
from qhbmlib_tpu_torch.inference.qnn import AnalyticQuantumInference
from qhbmlib_tpu_torch.inference.qnn import QuantumInference
from qhbmlib_tpu_torch.inference.vqt_loss import make_vqt
