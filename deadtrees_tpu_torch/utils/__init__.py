from deadtrees_tpu_torch.utils.env import get_env, load_envs
from deadtrees_tpu_torch.utils.logging import get_logger
from deadtrees_tpu_torch.utils.timer import record_execution_time

__all__ = ["get_env", "get_logger", "load_envs", "record_execution_time"]
