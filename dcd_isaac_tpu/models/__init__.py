from .common import RNNCore
from .multigrid_models import MultigridNetwork
from . import distributions, popart
