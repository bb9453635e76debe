from repro_torch.optim.adamw import adamw_update, global_norm, init_opt_state, lr_schedule
from repro_torch.optim.compress import compress_grads, init_error_state

__all__ = ["adamw_update", "global_norm", "init_opt_state", "lr_schedule",
           "compress_grads", "init_error_state"]
