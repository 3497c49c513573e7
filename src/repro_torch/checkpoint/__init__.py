from repro_torch.checkpoint.store import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
