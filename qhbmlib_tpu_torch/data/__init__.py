"""Quantum data sources (port of `qhbmlib_tpu/data/`: QHBM data and exact
thermal-state data)."""

from qhbmlib_tpu_torch.data.qhbm_data import QHBMData
from qhbmlib_tpu_torch.data.quantum_data import QuantumData
from qhbmlib_tpu_torch.data.thermal_data import ThermalStateData
