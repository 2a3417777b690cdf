"""Model parameterizations as nn.Modules (energies, circuits) and
Hamiltonians built from them."""

from qhbmlib_tpu_torch.models.circuit import ConstantCircuit
from qhbmlib_tpu_torch.models.circuit import DirectQuantumCircuit
from qhbmlib_tpu_torch.models.circuit import QAIA
from qhbmlib_tpu_torch.models.circuit import QuantumCircuit
from qhbmlib_tpu_torch.models.circuit_utils import hardware_efficient_ansatz
from qhbmlib_tpu_torch.models.energy import BernoulliEnergy
from qhbmlib_tpu_torch.models.energy import BitstringEnergy
from qhbmlib_tpu_torch.models.energy import KOBE
from qhbmlib_tpu_torch.models.energy import PauliMixin
from qhbmlib_tpu_torch.models.energy_utils import Parity
from qhbmlib_tpu_torch.models.energy_utils import SpinsFromBitstrings
from qhbmlib_tpu_torch.models.energy_utils import VariableDot
from qhbmlib_tpu_torch.models.hamiltonian import Hamiltonian
