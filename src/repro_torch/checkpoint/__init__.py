from .ckpt import save, save_async, restore, latest_step

__all__ = ["save", "save_async", "restore", "latest_step"]
