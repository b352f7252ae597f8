from .regressor import Regressor
from .letkf import letkf_analysis, gaspari_cohn
