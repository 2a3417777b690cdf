"""Inference engines, the VQT and QMHL losses and their metrics."""

from qhbmlib_tpu_torch.inference.ebm import AnalyticEnergyInference
from qhbmlib_tpu_torch.inference.ebm import BernoulliEnergyInference
from qhbmlib_tpu_torch.inference.ebm import EnergyInference
from qhbmlib_tpu_torch.inference.ebm import GibbsWithGradientsInference
from qhbmlib_tpu_torch.inference.qhbm import QHBM
from qhbmlib_tpu_torch.inference.qmhl_loss import make_qmhl
from qhbmlib_tpu_torch.inference.qmhl_loss import make_qmhl_with_state
from qhbmlib_tpu_torch.inference.qnn import AnalyticQuantumInference
from qhbmlib_tpu_torch.inference.qnn import QuantumInference
from qhbmlib_tpu_torch.inference.vqt_loss import make_vqt
