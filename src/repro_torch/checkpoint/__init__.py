from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step, restore_checkpoint,
                                         save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "AsyncCheckpointer"]
