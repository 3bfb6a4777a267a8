from repro_torch.optim.adamw import Optimizer, adamw
from repro_torch.optim.lamb import lamb

__all__ = ["Optimizer", "adamw", "lamb"]
