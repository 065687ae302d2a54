"""Model definitions of the port."""
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import moe

__all__ = ['llama', 'moe']
