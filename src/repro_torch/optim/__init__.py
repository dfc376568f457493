from repro_torch.optim.adamw import Adafactor, AdamW, clip_by_global_norm
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamW", "Adafactor", "clip_by_global_norm", "warmup_cosine"]
