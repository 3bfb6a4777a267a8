from repro_torch.ckpt.checkpoint import (available_steps, latest_step,
                                         prune_checkpoints,
                                         restore_checkpoint,
                                         save_checkpoint, stage_dir)

__all__ = ["save_checkpoint", "restore_checkpoint", "available_steps",
           "latest_step", "prune_checkpoints", "stage_dir"]
