from deadtrees_tpu_torch.utils.timer import record_execution_time

__all__ = ["record_execution_time"]
