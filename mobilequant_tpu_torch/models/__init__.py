from mobilequant_tpu_torch.models.config import ModelConfig
from mobilequant_tpu_torch.models.registry import MODEL_CONFIGS, get_config

__all__ = ["ModelConfig", "MODEL_CONFIGS", "get_config"]
