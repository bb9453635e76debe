from repro_torch.checkpoint.store import all_steps, latest, meta, restore, save

__all__ = ["all_steps", "latest", "meta", "restore", "save"]
