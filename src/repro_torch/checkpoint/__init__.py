from .ckpt import save_checkpoint, restore_checkpoint, latest_step, CheckpointManager

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]
