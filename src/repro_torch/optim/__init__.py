"""Local optimizers."""
from repro_torch.optim.sgdm import momentum_sgd_init, momentum_sgd_step
from repro_torch.optim.adamw import adamw_init, adamw_step
