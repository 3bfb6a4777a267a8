from repro_torch.optim.adamw import Optimizer, adamw
from repro_torch.optim.dpu import delayed_parameter_updates
from repro_torch.optim.lamb import lamb

__all__ = ["Optimizer", "adamw", "delayed_parameter_updates", "lamb"]
