"""Training-side helpers the serving path uses (prompt synthesis)."""
from repro_torch.training.data import make_prompts

__all__ = ["make_prompts"]
