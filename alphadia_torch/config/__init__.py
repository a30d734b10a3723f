from alphadia_torch.config.config import Config, load_default_config

__all__ = ["Config", "load_default_config"]
