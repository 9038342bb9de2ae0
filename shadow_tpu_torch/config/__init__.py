from shadow_tpu_torch.config.loader import load_config, load_config_str
from shadow_tpu_torch.config.schema import ConfigOptions

__all__ = ["ConfigOptions", "load_config", "load_config_str"]
