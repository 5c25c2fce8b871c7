from deadtrees_tpu_torch.config.loader import ConfigError, compose, print_config, to_yaml

__all__ = ["ConfigError", "compose", "print_config", "to_yaml"]
